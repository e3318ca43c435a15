// parasuite_native — host-side C++ fast paths.
//
// A copy of parasuite_tpu/native/parasuite_native.cpp, built on its own for
// the port. Replacement for the reference's native index-construction and
// record-parsing code (upstream BWA bwtindex.c/is.c build the BWT/suffix
// array in C; SURVEY.md §2 components 5 and 9). The device consumes a dense
// k-mer bucket index instead of a BWT, so the native job here is the
// counting sort that builds it, plus FASTQ tokenization+2-bit encoding for
// the 50M-read streaming configs. Exposed as a plain C ABI consumed via
// ctypes (no pybind11 in this environment); the numpy fallbacks in
// index/kmer.py and io/fastq.py produce bit-identical outputs (enforced by
// tests/test_native.py and tests/test_torch_host_copies.py). It differs from
// the original in two places: ps_bam_sort spills its sorted runs into a
// directory the caller names (the output's own), through unlinked mkstemp
// files, and closes every run file when a write fails (ABI 5); and
// ps_tracebacks_batch, the gapped rows' banded DP, traceback walk and NM,
// whose numpy fallback is pipeline/align.py::host_tracebacks_batch's own
// DP and walk, bit-identical (tests/test_torch_native_traceback.py; ABI 6).
//
// Build: make -C parasuite_tpu_torch/native   ->  libparasuite_native.so

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <algorithm>
#include <queue>
#include <thread>
#include <vector>

#include <unistd.h>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// k-mer index construction: counting sort over rolling 2-bit codes.
// seq: int8 codes 0..4 (4 = N), length n. k <= 15.
// bucket_starts: int32[4^k + 1] (out). positions: int32[capacity] (out),
// capacity must be >= number of valid k-mers (n - k + 1 upper bound).
// Returns the number of k-mers written, or -1 on error.
// Positions within a bucket come out ascending (iteration order), matching
// numpy's stable (code, position) sort — determinism contract.
// ---------------------------------------------------------------------------
int64_t ps_kmer_index_build(const int8_t* seq, int64_t n, int32_t k,
                            int32_t* bucket_starts, int32_t* positions) {
    if (k < 1 || k > 15 || n < 0) return -1;
    const int64_t nb = int64_t(1) << (2 * k);
    const uint64_t mask = uint64_t(nb) - 1;

    // pass 1: count occurrences per code
    std::vector<int32_t> counts(size_t(nb), 0);
    uint64_t code = 0;
    int64_t run = 0, total = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int8_t b = seq[i];
        if (b < 0 || b >= 4) {
            run = 0;
            code = 0;
        } else {
            code = ((code << 2) | uint64_t(b)) & mask;
            ++run;
        }
        if (run >= k) {
            ++counts[code];
            ++total;
        }
    }
    if (total > INT32_MAX) return -1;

    // exclusive prefix sum -> bucket_starts
    int64_t s = 0;
    for (int64_t c = 0; c < nb; ++c) {
        bucket_starts[c] = int32_t(s);
        s += counts[c];
    }
    bucket_starts[nb] = int32_t(s);

    // pass 2: fill positions using per-bucket cursors
    std::vector<int32_t> cursor(bucket_starts, bucket_starts + nb);
    code = 0; run = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int8_t b = seq[i];
        if (b < 0 || b >= 4) { run = 0; code = 0; }
        else { code = ((code << 2) | uint64_t(b)) & mask; ++run; }
        if (run >= k) positions[cursor[code]++] = int32_t(i - k + 1);
    }
    return total;
}

// ---------------------------------------------------------------------------
// FASTQ chunk scanner: tokenize complete 4-line records from buf, 2-bit
// encode sequences into fixed-shape [max_reads, max_len] code rows
// (pre-initialized by caller to 4 = N padding).
//   codes      int8 [max_reads * max_len]
//   lengths    int32[max_reads]
//   names      char [names_cap]         (concatenated, no separators)
//   name_off   int64[max_reads + 1]     (name_off[0] must be 0 on entry)
//   quals      char [max_reads * max_len] (space-padded)
//   consumed   out: bytes of buf consumed (complete records only)
// Returns number of records parsed (>= 0), or -1 on malformed input.
// ---------------------------------------------------------------------------
int64_t ps_fastq_scan(const char* buf, int64_t len, int64_t max_reads,
                      int32_t max_len, int8_t* codes, int32_t* lengths,
                      char* names, int64_t names_cap, int64_t* name_off,
                      char* quals, int64_t* consumed) {
    static int8_t lut[256];
    static bool lut_init = false;
    if (!lut_init) {
        for (int i = 0; i < 256; ++i) lut[i] = 4;
        lut['A'] = 0; lut['a'] = 0;
        lut['C'] = 1; lut['c'] = 1;
        lut['G'] = 2; lut['g'] = 2;
        lut['T'] = 3; lut['t'] = 3;
        lut_init = true;
    }
    // memchr line scanning: SIMD newline search beats the byte loop ~8x on
    // the 4 MB streaming chunks (the reader thread is a measured pipeline
    // stage — tools/profile_e2e.py)
    auto find_nl = [&](int64_t from) -> int64_t {
        if (from >= len) return len;
        const void* hit = std::memchr(buf + from, '\n', size_t(len - from));
        return hit ? int64_t(static_cast<const char*>(hit) - buf) : len;
    };
    int64_t pos = 0, nrec = 0, namew = name_off[0];
    *consumed = 0;
    while (nrec < max_reads) {
        int64_t p = pos;
        // line 1: @name
        while (p < len && (buf[p] == '\n' || buf[p] == '\r')) ++p;
        if (p >= len) break;
        if (buf[p] != '@') return -1;
        int64_t h0 = p + 1;
        int64_t h1 = find_nl(h0);
        if (h1 >= len) break;  // incomplete record
        int64_t tok = h0;
        while (tok < h1 && buf[tok] != ' ' && buf[tok] != '\t'
               && buf[tok] != '\r') ++tok;
        // line 2: sequence
        int64_t s0 = h1 + 1;
        int64_t s1 = find_nl(s0);
        if (s1 >= len) break;
        int64_t slen = s1 - s0;
        if (slen > 0 && buf[s1 - 1] == '\r') --slen;
        // line 3: +
        int64_t q0 = s1 + 1;
        if (q0 >= len) break;
        if (buf[q0] != '+') return -1;
        int64_t q1 = find_nl(q0);
        if (q1 >= len) break;
        // line 4: quality
        int64_t u0 = q1 + 1;
        int64_t u1 = find_nl(u0);
        if (u1 >= len && u1 - u0 < slen) break;  // incomplete
        int64_t qlen = u1 - u0;
        if (qlen > 0 && u1 > u0 && buf[u1 - 1] == '\r') --qlen;

        if (namew + (tok - h0) > names_cap) break;  // caller re-calls bigger
        // commit record
        std::memcpy(names + namew, buf + h0, size_t(tok - h0));
        namew += tok - h0;
        name_off[nrec + 1] = namew;
        const int32_t L = int32_t(slen < max_len ? slen : max_len);
        lengths[nrec] = L;
        int8_t* crow = codes + nrec * int64_t(max_len);
        char* qrow = quals + nrec * int64_t(max_len);
        for (int32_t i = 0; i < L; ++i) {
            crow[i] = lut[uint8_t(buf[s0 + i])];
            qrow[i] = (i < qlen) ? buf[u0 + i] : 'I';
        }
        ++nrec;
        pos = (u1 < len) ? u1 + 1 : len;
        *consumed = pos;
    }
    return nrec;
}

// library version tag for the ctypes wrapper's compatibility check
int32_t ps_abi_version(void) { return 6; }

// ---------------------------------------------------------------------------
// SAM cluster-ingestion scanner (SURVEY.md §3.5; BASELINE config 5 scale).
// Parses complete SAM data lines from buf and emits, per mapped record with
// a known RNAME, the three columns cluster calling needs:
//   out_pos  int64  packed start coordinate
//   out_span int32  reference bases consumed (M + D + N)
//   out_tc   int32  machine-frame T->C count over M segments
//       (genome-frame SEQ vs packed ref: fwd (refT, readC), rev (refA,
//        readG) — same walk as pipeline/clusters.tc_count_from_cigar)
// Header lines and unmapped/unknown-RNAME records are skipped (counted in
// *n_skipped). Stops at max_recs or at an incomplete trailing line.
// Returns records written, or -1 on malformed input.
// ---------------------------------------------------------------------------
int64_t ps_sam_cluster_scan(
    const char* buf, int64_t len,
    const int8_t* ref, int64_t ref_len,
    const char* rnames, const int64_t* rname_off, int64_t n_rnames,
    const int64_t* rname_starts,
    int64_t max_recs,
    int64_t* out_pos, int32_t* out_span, int32_t* out_tc,
    int64_t* consumed, int64_t* n_skipped) {
    static int8_t lut[256];
    static bool lut_init = false;
    if (!lut_init) {
        for (int i = 0; i < 256; ++i) lut[i] = 4;
        lut['A'] = 0; lut['a'] = 0;
        lut['C'] = 1; lut['c'] = 1;
        lut['G'] = 2; lut['g'] = 2;
        lut['T'] = 3; lut['t'] = 3;
        lut_init = true;
    }
    int64_t pos = 0, nrec = 0;
    int64_t last_ci = -1;  // records cluster by chrom runs: cache the lookup
    *consumed = 0;
    *n_skipped = 0;
    while (nrec < max_recs && pos < len) {
        const void* nl = std::memchr(buf + pos, '\n', size_t(len - pos));
        if (nl == nullptr) break;  // incomplete line
        const int64_t e = int64_t(static_cast<const char*>(nl) - buf);
        const int64_t line_end = (e > pos && buf[e - 1] == '\r') ? e - 1 : e;
        if (buf[pos] == '@' || line_end == pos) {  // header / blank
            pos = e + 1; *consumed = pos;
            continue;
        }
        // tokenize the first 10 tab-separated fields
        int64_t f[11];
        f[0] = pos;
        int nf = 1;
        for (int64_t p = pos; p < line_end && nf < 11; ++p)
            if (buf[p] == '\t') f[nf++] = p + 1;
        if (nf < 10) return -1;
        const int64_t fend_flag = f[2] - 1, fend_rname = f[3] - 1;
        const int64_t fend_pos = f[4] - 1, fend_cigar = f[6] - 1;
        // FLAG
        int64_t flag = 0;
        for (int64_t p = f[1]; p < fend_flag; ++p) {
            if (buf[p] < '0' || buf[p] > '9') return -1;
            flag = flag * 10 + (buf[p] - '0');
        }
        if (flag & 0x4) { ++*n_skipped; pos = e + 1; *consumed = pos; continue; }
        // RNAME lookup (cached; then linear — chrom tables are small)
        const char* rn = buf + f[2];
        const int64_t rl = fend_rname - f[2];
        int64_t ci = -1;
        if (last_ci >= 0 &&
            rname_off[last_ci + 1] - rname_off[last_ci] == rl &&
            std::memcmp(rnames + rname_off[last_ci], rn, size_t(rl)) == 0) {
            ci = last_ci;
        } else {
            for (int64_t c = 0; c < n_rnames; ++c) {
                if (rname_off[c + 1] - rname_off[c] == rl &&
                    std::memcmp(rnames + rname_off[c], rn, size_t(rl)) == 0) {
                    ci = c;
                    break;
                }
            }
        }
        if (ci < 0) { ++*n_skipped; pos = e + 1; *consumed = pos; continue; }
        last_ci = ci;
        // POS (1-based)
        int64_t p1 = 0;
        for (int64_t p = f[3]; p < fend_pos; ++p) {
            if (buf[p] < '0' || buf[p] > '9') return -1;
            p1 = p1 * 10 + (buf[p] - '0');
        }
        const int64_t packed = rname_starts[ci] + p1 - 1;
        // CIGAR walk + T->C over M segments against SEQ (field 10)
        const bool rev = (flag & 0x10) != 0;
        int64_t ri = packed;
        const char* seq = buf + f[9];
        const int64_t qlen = f[10] - 1 - f[9];
        int64_t qi = 0;
        int64_t span = 0;
        int32_t tc = 0;
        bool ok = true;
        int64_t p = f[5];
        if (p < fend_cigar && buf[p] == '*') { ++*n_skipped; pos = e + 1; *consumed = pos; continue; }
        while (p < fend_cigar) {
            int64_t ln = 0;
            while (p < fend_cigar && buf[p] >= '0' && buf[p] <= '9')
                ln = ln * 10 + (buf[p++] - '0');
            if (p >= fend_cigar || ln <= 0) { ok = false; break; }
            const char op = buf[p++];
            if (op == 'M' || op == '=' || op == 'X') {
                if (ri < 0 || ri + ln > ref_len || qi + ln > qlen) {
                    ok = false;
                    break;
                }
                if (rev) {
                    for (int64_t k = 0; k < ln; ++k)
                        tc += (ref[ri + k] == 0) & (lut[uint8_t(seq[qi + k])] == 2);
                } else {
                    for (int64_t k = 0; k < ln; ++k)
                        tc += (ref[ri + k] == 3) & (lut[uint8_t(seq[qi + k])] == 1);
                }
                ri += ln; qi += ln; span += ln;
            } else if (op == 'I' || op == 'S') {
                qi += ln;
            } else if (op == 'D' || op == 'N') {
                ri += ln; span += ln;
            } else {
                ok = false;
                break;
            }
        }
        if (!ok) return -1;
        out_pos[nrec] = packed;
        out_span[nrec] = int32_t(span);
        out_tc[nrec] = tc;
        ++nrec;
        pos = e + 1;
        *consumed = pos;
    }
    return nrec;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// Batch SAM record formatter. Emits the same bytes as
// io/sam.py::format_record (parity enforced by tests/test_native.py).
//
// ref:        int8 packed reference codes (for NM-checked MD tag)
// codes:      int8 [n, max_len] machine-frame read codes
// names/name_off: concatenated qnames
// rnames/rname_off: chromosome name table
// For record i: flag[i] in {0,4,16}; rname_idx[i]; pos1[i] 1-based local;
// packed_pos[i] packed coordinate of the alignment start (for MD);
// if flag==4 only name/codes/qual are used.
// cig_off/cig_ops/cig_lens: optional per-record CIGARs (cig_off int64
// [n+1] into the flat op arrays; op codes 0=M 1=I 2=D 3=N — BAM opcodes).
// cig_off == NULL, or an empty range, means the default single "LM" run —
// so junction (N) and gapped (I/D) records format natively too, one call
// per batch instead of one per run fragment.
// Returns bytes written into out (cap bytes) or -1 if out too small.
// ---------------------------------------------------------------------------
int64_t ps_sam_format_batch(
    const int8_t* ref, int64_t ref_len,
    int64_t n, int32_t max_len,
    const int8_t* codes, const int32_t* lengths,
    const char* names, const int64_t* name_off,
    const char* quals,  // [n * max_len], machine orientation
    const char* rnames, const int64_t* rname_off,
    const int32_t* flag, const int32_t* rname_idx, const int32_t* pos1,
    const int64_t* packed_pos, const int32_t* mapq, const int32_t* nm,
    const int32_t* x0, const int32_t* x1, const int32_t* score,
    const int64_t* cig_off, const uint8_t* cig_ops, const int32_t* cig_lens,
    char* out, int64_t cap) {
    static const char BASE[5] = {'A', 'C', 'G', 'T', 'N'};
    static const char COMP[5] = {'T', 'G', 'C', 'A', 'N'};
    static const char OPC[4] = {'M', 'I', 'D', 'N'};
    int64_t w = 0;

    auto put = [&](const char* s, int64_t ln) -> bool {
        if (w + ln > cap) return false;
        std::memcpy(out + w, s, size_t(ln));
        w += ln;
        return true;
    };
    // manual itoa: snprintf measured ~10x slower and runs ~10x per record
    auto put_int = [&](int64_t v) -> bool {
        char tmp[20];
        if (w + 21 > cap) return false;
        if (v < 0) { out[w++] = '-'; v = -v; }
        int ln = 0;
        do { tmp[ln++] = char('0' + v % 10); v /= 10; } while (v);
        while (ln) out[w++] = tmp[--ln];
        return true;
    };
    auto put_c = [&](char c) -> bool {
        if (w + 1 > cap) return false;
        out[w++] = c;
        return true;
    };

    for (int64_t i = 0; i < n; ++i) {
        const int32_t L = lengths[i];
        const int8_t* crow = codes + i * int64_t(max_len);
        const char* qrow = quals + i * int64_t(max_len);
        const bool rev = (flag[i] & 0x10) != 0;
        const bool unmapped = (flag[i] & 0x4) != 0;
        const int64_t c0 = cig_off ? cig_off[i] : 0;
        const int64_t nops = cig_off ? cig_off[i + 1] - c0 : 0;
        // aligned (genome-frame) read base at offset k
        auto aligned = [&](int64_t k) -> int {
            const int8_t m = rev ? crow[L - 1 - k] : crow[k];
            const int c = (m >= 0 && m < 4) ? m : 4;
            return rev ? (c < 4 ? 3 - c : 4) : c;
        };
        // QNAME FLAG
        if (!put(names + name_off[i], name_off[i + 1] - name_off[i]))
            return -1;
        put_c('\t'); put_int(flag[i]); put_c('\t');
        if (unmapped) {
            if (!put("*\t0\t0\t*\t*\t0\t0\t", 14)) return -1;
        } else {
            const char* rn = rnames + rname_off[rname_idx[i]];
            int64_t rl = rname_off[rname_idx[i] + 1] - rname_off[rname_idx[i]];
            if (!put(rn, rl)) return -1;
            put_c('\t'); put_int(pos1[i]); put_c('\t'); put_int(mapq[i]);
            put_c('\t');
            if (nops == 0) {
                put_int(L);
                if (!put_c('M')) return -1;
            } else {
                for (int64_t c = 0; c < nops; ++c) {
                    if (cig_ops[c0 + c] > 3) return -1;
                    put_int(cig_lens[c0 + c]);
                    if (!put_c(OPC[cig_ops[c0 + c]])) return -1;
                }
            }
            if (!put("\t*\t0\t0\t", 7)) return -1;
        }
        // SEQ
        if (w + L + 1 > cap) return -1;
        if (!unmapped && rev) {
            for (int32_t k = 0; k < L; ++k)
                out[w + k] = COMP[crow[L - 1 - k] < 4 ? crow[L - 1 - k] : 4];
        } else {
            for (int32_t k = 0; k < L; ++k)
                out[w + k] = BASE[crow[k] < 4 ? crow[k] : 4];
        }
        w += L;
        put_c('\t');
        // QUAL
        if (w + L > cap) return -1;
        if (!unmapped && rev) {
            for (int32_t k = 0; k < L; ++k) out[w + k] = qrow[L - 1 - k];
        } else {
            std::memcpy(out + w, qrow, size_t(L));
        }
        w += L;
        if (unmapped) {
            if (!put_c('\n')) return -1;
            continue;
        }
        // tags: XT NM X0 X1 AS MD
        if (!put(x0[i] == 1 ? "\tXT:A:U\tNM:i:" : "\tXT:A:R\tNM:i:", 13))
            return -1;
        put_int(nm[i]);
        if (!put("\tX0:i:", 6)) return -1;
        put_int(x0[i]);
        if (!put("\tX1:i:", 6)) return -1;
        put_int(x1[i]);
        if (!put("\tAS:i:", 6)) return -1;
        put_int(score[i]);
        if (!put("\tMD:Z:", 6)) return -1;
        // MD walk over the CIGAR (samtools convention: match run lengths,
        // mismatch ref bases, ^-prefixed deletions; I consumes no MD, N
        // skips silently) — io/sam.py::md_tag semantics
        {
            int64_t ri = packed_pos[i];
            int64_t qi = 0;
            int run = 0;
            if (nops == 0) {
                // single L-length M; nm==0 fast path: MD is the run length
                if (ri < 0 || ri + L > ref_len) return -1;
                if (nm[i] == 0) {
                    put_int(L);
                } else {
                    for (int32_t k = 0; k < L; ++k) {
                        int rb = ref[ri + k];
                        if (rb < 0 || rb > 4) rb = 4;
                        if (rb == aligned(k) && rb < 4) { ++run; }
                        else {
                            put_int(run);
                            if (!put_c(BASE[rb])) return -1;
                            run = 0;
                        }
                    }
                    put_int(run);
                }
            } else {
                for (int64_t c = 0; c < nops; ++c) {
                    const int64_t ln = cig_lens[c0 + c];
                    const uint8_t op = cig_ops[c0 + c];
                    if (op == 0) {                       // M
                        if (ri < 0 || ri + ln > ref_len || qi + ln > L)
                            return -1;
                        for (int64_t k = 0; k < ln; ++k) {
                            int rb = ref[ri + k];
                            if (rb < 0 || rb > 4) rb = 4;
                            if (rb == aligned(qi + k) && rb < 4) { ++run; }
                            else {
                                put_int(run);
                                if (!put_c(BASE[rb])) return -1;
                                run = 0;
                            }
                        }
                        ri += ln; qi += ln;
                    } else if (op == 1) {                // I
                        qi += ln;
                    } else if (op == 2) {                // D
                        if (ri < 0 || ri + ln > ref_len) return -1;
                        put_int(run);
                        run = 0;
                        if (!put_c('^')) return -1;
                        for (int64_t k = 0; k < ln; ++k) {
                            int rb = ref[ri + k];
                            if (rb < 0 || rb > 4) rb = 4;
                            if (!put_c(BASE[rb])) return -1;
                        }
                        ri += ln;
                    } else {                             // N
                        ri += ln;
                    }
                }
                put_int(run);
            }
        }
        if (!put_c('\n')) return -1;
    }
    return w;
}

// ---------------------------------------------------------------------------
// Batch BAM record formatter — the binary twin of ps_sam_format_batch for the
// same dominant record shapes (ungapped "LM" mapped + unmapped). Emits BAM
// records (with block_size prefix) BYTE-IDENTICAL to what io/bam.py's
// encode_bam_record produces from the SAM text of ps_sam_format_batch, so
// "align -> .bam directly" equals "align -> .sam -> convert" bit for bit
// (tests/test_native.py). The reference's htsjdk writes BAM natively
// (SURVEY.md §2 component 9); this is the streaming-writer equivalent, so
// .bam outputs need no .tmp.sam double pass (VERDICT r3 weak #3).
// Same inputs as ps_sam_format_batch. Returns bytes written or -1.
// ---------------------------------------------------------------------------
static int32_t bam_reg2bin(int64_t beg, int64_t end) {
    --end;
    if (beg >> 14 == end >> 14) return int32_t(((1 << 15) - 1) / 7 + (beg >> 14));
    if (beg >> 17 == end >> 17) return int32_t(((1 << 12) - 1) / 7 + (beg >> 17));
    if (beg >> 20 == end >> 20) return int32_t(((1 << 9) - 1) / 7 + (beg >> 20));
    if (beg >> 23 == end >> 23) return int32_t(((1 << 6) - 1) / 7 + (beg >> 23));
    if (beg >> 26 == end >> 26) return int32_t(((1 << 3) - 1) / 7 + (beg >> 26));
    return 0;
}

int64_t ps_bam_format_batch(
    const int8_t* ref, int64_t ref_len,
    int64_t n, int32_t max_len,
    const int8_t* codes, const int32_t* lengths,
    const char* names, const int64_t* name_off,
    const char* quals,
    const char* rnames, const int64_t* rname_off,  // unused: refID is numeric
    const int32_t* flag, const int32_t* rname_idx, const int32_t* pos1,
    const int64_t* packed_pos, const int32_t* mapq, const int32_t* nm,
    const int32_t* x0, const int32_t* x1, const int32_t* score,
    const int64_t* cig_off, const uint8_t* cig_ops, const int32_t* cig_lens,
    char* out, int64_t cap) {
    (void)rnames; (void)rname_off;
    // SAM nibble codes for machine codes 0..4 (A,C,G,T,N) and complements
    static const uint8_t NIB[5] = {1, 2, 4, 8, 15};
    static const uint8_t NIB_C[5] = {8, 4, 2, 1, 15};
    static const char BASE[5] = {'A', 'C', 'G', 'T', 'N'};
    int64_t w = 0;

    auto put = [&](const void* s, int64_t ln) -> bool {
        if (w + ln > cap) return false;
        std::memcpy(out + w, s, size_t(ln));
        w += ln;
        return true;
    };
    auto put_i32 = [&](int32_t v) -> bool { return put(&v, 4); };
    auto put_u16 = [&](uint16_t v) -> bool { return put(&v, 2); };
    auto put_u8 = [&](uint8_t v) -> bool { return put(&v, 1); };
    // MD text written into a small stack buffer (<= ~3*L + slack)
    char md[1024];

    for (int64_t i = 0; i < n; ++i) {
        const int32_t L = lengths[i];
        const int8_t* crow = codes + i * int64_t(max_len);
        const char* qrow = quals + i * int64_t(max_len);
        const bool rev = (flag[i] & 0x10) != 0;
        const bool unmapped = (flag[i] & 0x4) != 0;
        const int64_t nlen = name_off[i + 1] - name_off[i];
        if (nlen + 1 > 255) return -1;
        const int64_t c0 = cig_off ? cig_off[i] : 0;
        const int64_t nops = (cig_off && !unmapped) ? cig_off[i + 1] - c0 : 0;
        auto aligned = [&](int64_t k) -> int {
            const int8_t m = rev ? crow[L - 1 - k] : crow[k];
            const int c = (m >= 0 && m < 4) ? m : 4;
            return rev ? (c < 4 ? 3 - c : 4) : c;
        };

        int64_t ref_span = 0;
        if (!unmapped) {
            if (nops == 0) ref_span = L;
            else
                for (int64_t c = 0; c < nops; ++c)
                    if (cig_ops[c0 + c] != 1) ref_span += cig_lens[c0 + c];
        }

        int mdlen = 0;
        if (!unmapped) {
            // MD walk over the CIGAR (io/sam.py::md_tag semantics)
            int64_t ri = packed_pos[i];
            int64_t qi = 0;
            int run = 0;
            char* m = md;
            auto flushrun = [&]() {
                m += std::snprintf(m, size_t(md + sizeof md - m), "%d", run);
                run = 0;
            };
            if (nops == 0 && nm[i] == 0) {
                if (ri < 0 || ri + L > ref_len) return -1;
                mdlen = std::snprintf(md, sizeof md, "%d", L);
            } else {
                const int64_t n_walk = nops == 0 ? 1 : nops;
                for (int64_t c = 0; c < n_walk; ++c) {
                    const int64_t ln = nops == 0 ? L : cig_lens[c0 + c];
                    const uint8_t op = nops == 0 ? 0 : cig_ops[c0 + c];
                    if (op == 0) {
                        if (ri < 0 || ri + ln > ref_len || qi + ln > L)
                            return -1;
                        for (int64_t k = 0; k < ln; ++k) {
                            int rb = ref[ri + k];
                            if (rb < 0 || rb > 4) rb = 4;
                            if (rb == aligned(qi + k) && rb < 4) { ++run; }
                            else { flushrun(); *m++ = BASE[rb]; }
                            if (m - md > int64_t(sizeof md) - 16) return -1;
                        }
                        ri += ln; qi += ln;
                    } else if (op == 1) {
                        qi += ln;
                    } else if (op == 2) {
                        if (ri < 0 || ri + ln > ref_len) return -1;
                        flushrun();
                        *m++ = '^';
                        for (int64_t k = 0; k < ln; ++k) {
                            int rb = ref[ri + k];
                            if (rb < 0 || rb > 4) rb = 4;
                            *m++ = BASE[rb];
                            if (m - md > int64_t(sizeof md) - 16) return -1;
                        }
                        ri += ln;
                    } else if (op == 3) {
                        ri += ln;
                    } else {
                        return -1;
                    }
                }
                flushrun();
                mdlen = int(m - md);
            }
        }

        const int32_t n_cig = unmapped ? 0 : int32_t(nops == 0 ? 1 : nops);
        // tags: XT:A:c (4) + 3x i32 tags (NM,X0,X1 -> 7 each) + AS (7)
        //       + MD:Z: (3 + mdlen + 1) for mapped records; none unmapped
        const int32_t tag_bytes = unmapped ? 0
            : int32_t(4 + 7 * 4 + 3 + mdlen + 1);
        const int32_t body = 32 + int32_t(nlen) + 1 + 4 * n_cig
            + (L + 1) / 2 + L + tag_bytes;
        if (w + 4 + body > cap) return -1;
        put_i32(body);
        const int32_t refid = unmapped ? -1 : rname_idx[i];
        const int64_t pos0 = unmapped ? -1 : int64_t(pos1[i]) - 1;
        put_i32(refid);
        put_i32(int32_t(pos0));
        put_u8(uint8_t(nlen + 1));
        put_u8(uint8_t(unmapped ? 0 : mapq[i]));
        const int64_t span1 = ref_span > 1 ? ref_span : 1;
        const int32_t bin = unmapped ? 4680
            : bam_reg2bin(pos0 > 0 ? pos0 : 0,
                          (pos0 + span1) > 1 ? pos0 + span1 : 1);
        put_u16(uint16_t(bin));
        put_u16(uint16_t(n_cig));
        put_u16(uint16_t(flag[i]));
        put_i32(L);
        put_i32(-1);          // next_refID
        put_i32(-1);          // next_pos
        put_i32(0);           // tlen
        put(names + name_off[i], nlen);
        put_u8(0);
        if (!unmapped) {
            if (nops == 0) {
                put_i32((L << 4) | 0);  // "LM"
            } else {
                for (int64_t c = 0; c < nops; ++c) {
                    if (cig_ops[c0 + c] > 3) return -1;
                    put_i32((cig_lens[c0 + c] << 4) | cig_ops[c0 + c]);
                }
            }
        }
        // SEQ nibbles (genome orientation: revcomp for reverse strand —
        // unmapped records keep machine orientation, like the SAM text)
        {
            uint8_t byte = 0;
            for (int32_t k = 0; k < L; ++k) {
                int8_t c;
                uint8_t nib;
                if (!unmapped && rev) {
                    c = crow[L - 1 - k];
                    nib = NIB_C[(c >= 0 && c < 4) ? c : 4];
                } else {
                    c = crow[k];
                    nib = NIB[(c >= 0 && c < 4) ? c : 4];
                }
                if (k % 2 == 0) byte = uint8_t(nib << 4);
                else { byte |= nib; put_u8(byte); }
            }
            if (L % 2) put_u8(byte);
        }
        // QUAL (phred, reversed for reverse strand)
        if (w + L > cap) return -1;
        if (!unmapped && rev) {
            for (int32_t k = 0; k < L; ++k)
                out[w + k] = char(uint8_t(qrow[L - 1 - k]) - 33);
        } else {
            for (int32_t k = 0; k < L; ++k)
                out[w + k] = char(uint8_t(qrow[k]) - 33);
        }
        w += L;
        if (unmapped) continue;
        // tags (binary layout of io/bam.py _encode_tags on the SAM text)
        put("XTA", 3);
        put_u8(uint8_t(x0[i] == 1 ? 'U' : 'R'));
        put("NMi", 3); put_i32(nm[i]);
        put("X0i", 3); put_i32(x0[i]);
        put("X1i", 3); put_i32(x1[i]);
        put("ASi", 3); put_i32(score[i]);
        put("MDZ", 3);
        put(md, mdlen);
        put_u8(0);
    }
    return w;
}

// ---------------------------------------------------------------------------
// BGZF compressor: src -> spec BGZF members (<= 65280 bytes of payload each,
// gzip header with the BC/BSIZE extra subfield), same framing as io/bam.py's
// BgzfWriter so either writer produces valid, samtools-readable output.
// Returns compressed bytes written into out, or -1 (buffer too small /
// zlib error). level: zlib 1..9.
// ---------------------------------------------------------------------------
int64_t ps_bgzf_compress(const uint8_t* src, int64_t len, int32_t level,
                         uint8_t* out, int64_t cap) {
    const int64_t MAXB = 65280;
    int64_t w = 0;
    int64_t off = 0;
    while (off < len) {
        const int64_t chunk = (len - off < MAXB) ? len - off : MAXB;
        z_stream zs;
        std::memset(&zs, 0, sizeof zs);
        if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                         Z_DEFAULT_STRATEGY) != Z_OK) return -1;
        const uint64_t bound = deflateBound(&zs, uLong(chunk));
        if (w + 18 + int64_t(bound) + 8 > cap) { deflateEnd(&zs); return -1; }
        uint8_t* hdr = out + w;
        zs.next_in = const_cast<Bytef*>(src + off);
        zs.avail_in = uInt(chunk);
        zs.next_out = hdr + 18;
        zs.avail_out = uInt(bound);
        if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
            deflateEnd(&zs);
            return -1;
        }
        const int64_t clen = int64_t(zs.total_out);
        deflateEnd(&zs);
        const int64_t total = 12 + 6 + clen + 8;
        if (total - 1 > 65535) return -1;
        // gzip member header with BC extra subfield (SAM spec §4.1)
        hdr[0] = 0x1f; hdr[1] = 0x8b; hdr[2] = 8; hdr[3] = 4;
        std::memset(hdr + 4, 0, 5);
        hdr[9] = 0xff;
        hdr[10] = 6; hdr[11] = 0;           // XLEN
        hdr[12] = 66; hdr[13] = 67;         // 'B','C'
        hdr[14] = 2; hdr[15] = 0;           // SLEN
        const uint16_t bsize = uint16_t(total - 1);
        std::memcpy(hdr + 16, &bsize, 2);
        const uint32_t crc = uint32_t(
            crc32(crc32(0L, Z_NULL, 0), src + off, uInt(chunk)));
        const uint32_t isize = uint32_t(chunk);
        std::memcpy(hdr + 18 + clen, &crc, 4);
        std::memcpy(hdr + 18 + clen + 4, &isize, 4);
        w += total;
        off += chunk;
    }
    return w;
}

// ---------------------------------------------------------------------------
// BAM-record cluster scanner: the binary twin of ps_sam_cluster_scan. buf
// holds UNCOMPRESSED BAM records (block_size-prefixed, header already
// consumed); refid_starts maps BAM refID -> packed start of that chromosome
// in ref (or -1 for unknown). Emits (packed_pos, ref_span, tc) per mapped
// record; unmapped / unknown-refID are counted in n_skipped. Stops at an
// incomplete trailing record. Returns records written or -1 on malformed.
// ---------------------------------------------------------------------------
int64_t ps_bam_cluster_scan(
    const uint8_t* buf, int64_t len,
    const int8_t* ref, int64_t ref_len,
    const int64_t* refid_starts, int64_t n_refids,
    int64_t max_recs,
    int64_t* out_pos, int32_t* out_span, int32_t* out_tc,
    int64_t* consumed, int64_t* n_skipped) {
    // BAM nibble -> machine code (A=1,C=2,G=4,T=8 -> 0,1,2,3; else 4)
    static int8_t NIB2CODE[16];
    static bool nib_init = false;
    if (!nib_init) {
        for (int i = 0; i < 16; ++i) NIB2CODE[i] = 4;
        NIB2CODE[1] = 0; NIB2CODE[2] = 1; NIB2CODE[4] = 2; NIB2CODE[8] = 3;
        nib_init = true;
    }
    int64_t pos = 0, nrec = 0;
    *consumed = 0;
    *n_skipped = 0;
    while (nrec < max_recs && pos + 4 <= len) {
        int32_t bsz;
        std::memcpy(&bsz, buf + pos, 4);
        if (bsz < 32) return -1;
        if (pos + 4 + bsz > len) break;  // incomplete record
        const uint8_t* b = buf + pos + 4;
        int32_t refid, p0, l_seq;
        uint16_t n_cig, fl;
        std::memcpy(&refid, b, 4);
        std::memcpy(&p0, b + 4, 4);
        const uint8_t l_name = b[8];
        std::memcpy(&n_cig, b + 12, 2);
        std::memcpy(&fl, b + 14, 2);
        std::memcpy(&l_seq, b + 16, 4);
        // Bounds: cig/seq offsets derived from l_name/n_cig/l_seq must land
        // inside this record's bsz bytes, or a malformed-but-BGZF-valid BAM
        // would drive the parse loop out of bounds (ADVICE r4 medium).
        if (l_seq < 0 ||
            int64_t(32) + l_name + int64_t(4) * n_cig +
                    (int64_t(l_seq) + 1) / 2 > int64_t(bsz))
            return -1;
        pos += 4 + bsz;
        *consumed = pos;
        if ((fl & 0x4) || refid < 0 || refid >= n_refids ||
            refid_starts[refid] < 0) {
            ++*n_skipped;
            continue;
        }
        const uint8_t* cig = b + 32 + l_name;
        const uint8_t* seq = cig + 4 * n_cig;
        const int64_t packed = refid_starts[refid] + p0;
        const bool rev = (fl & 0x10) != 0;
        int64_t ri = packed, qi = 0, span = 0;
        int32_t tc = 0;
        for (uint16_t c = 0; c < n_cig; ++c) {
            uint32_t v;
            std::memcpy(&v, cig + 4 * c, 4);
            const int64_t ln = v >> 4;
            const uint32_t op = v & 0xf;  // MIDNSHP=X
            if (op == 0 || op == 7 || op == 8) {        // M,=,X
                if (ri < 0 || ri + ln > ref_len || qi + ln > l_seq) return -1;
                for (int64_t k = 0; k < ln; ++k) {
                    const int64_t q = qi + k;
                    const uint8_t nib = (q % 2 == 0) ? (seq[q / 2] >> 4)
                                                     : (seq[q / 2] & 0xf);
                    const int8_t rc = NIB2CODE[nib];
                    if (rev) tc += (ref[ri + k] == 0) & (rc == 2);
                    else tc += (ref[ri + k] == 3) & (rc == 1);
                }
                ri += ln; qi += ln; span += ln;
            } else if (op == 1 || op == 4) {            // I,S
                qi += ln;
            } else if (op == 2 || op == 3) {            // D,N
                ri += ln; span += ln;
            } else if (op == 5 || op == 6) {            // H,P
            } else {
                return -1;
            }
        }
        out_pos[nrec] = packed;
        out_span[nrec] = int32_t(span);
        out_tc[nrec] = tc;
        ++nrec;
    }
    return nrec;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native BAM coordinate sort — the C++ twin of io/bam.py::coordinate_sort for
// the .bam -> .bam case (the config-5 50M-record path, VERDICT r4 weak #3:
// the Python spill/merge loop + single-threaded deflate was ~42% of the
// config-5 pipeline). Bit-identical contract with the Python path, pinned by
// tests/test_bam.py::test_native_sort_parity:
//   * sort key (key_ref, POS) with key_ref = refid, or 2^62 for unmapped /
//     refid<0; stable (arrival order breaks ties) — matching
//     _iter_sort_items + the stable spill/merge;
//   * same min_mapq / mapped_only filter semantics;
//   * output framing identical to BgzfWriter: payload = header blob (built
//     by Python, SO:coordinate already applied) + length-prefixed records;
//     blocks cut exactly like BgzfWriter (flush the multiple-of-65280
//     prefix whenever the pending payload reaches 65280*64 after a record
//     append; final partial block at close; 28-byte EOF marker) with the
//     same zlib level — so the compressed bytes match the Python writer's.
// Records beyond max_in_memory spill as sorted runs of length-prefixed
// bodies (keys re-derived at merge) and k-way merge, like the Python path.
// Deflate runs 2-way block-parallel (BGZF members are independent), the
// measured bottleneck of the Python sort.
// ---------------------------------------------------------------------------

namespace {

constexpr int64_t kBgzfMax = 65280;
const uint8_t kBgzfEof[28] = {
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00};

// Streaming multi-member gzip inflater (BGZF is valid multi-member gzip).
struct GzInflater {
    FILE* f = nullptr;
    z_stream zs;
    std::vector<uint8_t> in;
    size_t in_off = 0, in_end = 0;
    bool stream_open = false, file_eof = false, failed = false;

    explicit GzInflater(FILE* fh) : f(fh), in(4 << 20) {
        std::memset(&zs, 0, sizeof zs);
        if (inflateInit2(&zs, 15 + 32) != Z_OK) failed = true;
        else stream_open = true;
    }
    ~GzInflater() { if (stream_open) inflateEnd(&zs); }

    // Fill dst with up to n decompressed bytes; returns bytes produced
    // (0 = clean EOF), or -1 on corrupt input.
    int64_t read(uint8_t* dst, int64_t n) {
        if (failed) return -1;
        int64_t got = 0;
        while (got < n) {
            if (in_off == in_end && !file_eof) {
                in_end = fread(in.data(), 1, in.size(), f);
                in_off = 0;
                if (in_end == 0) file_eof = true;
            }
            if (in_off == in_end && file_eof) break;
            zs.next_in = in.data() + in_off;
            zs.avail_in = uInt(in_end - in_off);
            zs.next_out = dst + got;
            zs.avail_out = uInt(n - got);
            const int rc = inflate(&zs, Z_NO_FLUSH);
            in_off = in_end - zs.avail_in;
            got = n - int64_t(zs.avail_out);
            if (rc == Z_STREAM_END) {
                if (inflateReset2(&zs, 15 + 32) != Z_OK) {
                    failed = true;
                    return -1;
                }
            } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
                failed = true;
                return -1;
            }
        }
        return got;
    }
};

// Buffered decompressed-byte reader with ensure()/skip() over GzInflater.
struct BamByteReader {
    GzInflater gz;
    std::vector<uint8_t> buf;
    size_t off = 0, end = 0;
    bool bad = false;

    explicit BamByteReader(FILE* f) : gz(f), buf(8 << 20) {}

    size_t avail() const { return end - off; }

    // Ensure >= need bytes buffered; false on EOF/corruption short of need.
    bool ensure(size_t need) {
        if (avail() >= need) return true;
        if (need > buf.size()) buf.resize(need + (4 << 20));
        if (off > 0) {
            std::memmove(buf.data(), buf.data() + off, avail());
            end -= off;
            off = 0;
        }
        while (avail() < need) {
            const int64_t got = gz.read(buf.data() + end, buf.size() - end);
            if (got < 0) { bad = true; return false; }
            if (got == 0) return false;
            end += size_t(got);
        }
        return true;
    }
    const uint8_t* data() const { return buf.data() + off; }
    void skip(size_t n) { off += n; }

    int32_t peek_i32(size_t at) const {
        int32_t v;
        std::memcpy(&v, data() + at, 4);
        return v;
    }
};

struct SortKey {
    uint64_t key_ref;
    int32_t pos;
    uint64_t arrival;   // in-memory tiebreak: global arrival index
    uint64_t arena_off;
    uint32_t len;
};

inline bool key_less(const SortKey& a, const SortKey& b) {
    if (a.key_ref != b.key_ref) return a.key_ref < b.key_ref;
    if (a.pos != b.pos) return a.pos < b.pos;
    return a.arrival < b.arrival;
}

constexpr uint64_t kUnmappedKey = uint64_t(1) << 62;

inline void derive_key(const uint8_t* body, uint64_t& key_ref, int32_t& pos) {
    int32_t refid;
    uint16_t fl;
    std::memcpy(&refid, body, 4);
    std::memcpy(&pos, body + 4, 4);
    std::memcpy(&fl, body + 14, 2);
    key_ref = ((fl & 0x4) || refid < 0) ? kUnmappedKey : uint64_t(refid);
}

// BGZF writer replicating BgzfWriter's block-cut policy byte for byte.
struct BgzfSink {
    FILE* f;
    int level;
    std::vector<uint8_t> pend;
    std::vector<uint8_t> comp;
    bool failed = false;

    BgzfSink(FILE* fh, int lvl) : f(fh), level(lvl) {
        pend.reserve(kBgzfMax * 66);
    }

    void write(const uint8_t* p, size_t n) {
        pend.insert(pend.end(), p, p + n);
        if (int64_t(pend.size()) >= kBgzfMax * 64) flush(false);
    }

    void flush(bool final_flush) {
        if (failed) return;
        const int64_t n = final_flush
            ? int64_t(pend.size())
            : int64_t(pend.size()) - int64_t(pend.size()) % kBgzfMax;
        if (n <= 0) return;
        if (comp.size() < size_t(n) + size_t(n >> 1) + (1 << 16))
            comp.resize(size_t(n) + size_t(n >> 1) + (1 << 16));
        // two-thread block-parallel deflate: BGZF members are independent,
        // so splitting at a 65280 multiple yields identical bytes
        const int64_t split = ((n / kBgzfMax) / 2) * kBgzfMax;
        int64_t w;
        if (split > 0 && n - split > 0) {
            const size_t cap2 = size_t(n - split) + size_t((n - split) >> 1)
                + (1 << 16);
            std::vector<uint8_t> comp2(cap2);
            int64_t w2 = 0;
            std::thread t([&] {
                w2 = ps_bgzf_compress(pend.data() + split, n - split,
                                      level, comp2.data(), int64_t(cap2));
            });
            w = ps_bgzf_compress(pend.data(), split, level, comp.data(),
                                 int64_t(comp.size()));
            t.join();
            if (w < 0 || w2 < 0 ||
                fwrite(comp.data(), 1, size_t(w), f) != size_t(w) ||
                fwrite(comp2.data(), 1, size_t(w2), f) != size_t(w2)) {
                failed = true;
                return;
            }
        } else {
            w = ps_bgzf_compress(pend.data(), n, level, comp.data(),
                                 int64_t(comp.size()));
            if (w < 0 ||
                fwrite(comp.data(), 1, size_t(w), f) != size_t(w)) {
                failed = true;
                return;
            }
        }
        pend.erase(pend.begin(), pend.begin() + n);
    }

    bool close() {
        flush(true);
        if (failed) return false;
        return fwrite(kBgzfEof, 1, 28, f) == 28;
    }
};

// Sequential reader over one spilled run (u32 len + body per record).
struct RunReader {
    FILE* f;
    std::vector<uint8_t> buf;
    size_t off = 0, end = 0;
    bool done = false, bad = false;
    uint64_t key_ref = 0;
    int32_t pos = 0;
    const uint8_t* body = nullptr;
    uint32_t len = 0;

    explicit RunReader(FILE* fh) : f(fh), buf(8 << 20) {}

    bool fill(size_t need) {
        if (end - off >= need) return true;
        if (need > buf.size()) buf.resize(need + (4 << 20));
        std::memmove(buf.data(), buf.data() + off, end - off);
        end -= off;
        off = 0;
        while (end - off < need) {
            const size_t got = fread(buf.data() + end, 1,
                                     buf.size() - end, f);
            if (got == 0) return false;
            end += got;
        }
        return true;
    }

    bool advance() {
        if (!fill(4)) { done = true; return false; }
        uint32_t ln;
        std::memcpy(&ln, buf.data() + off, 4);
        if (!fill(4 + size_t(ln))) { bad = true; done = true; return false; }
        off += 4;
        body = buf.data() + off;
        len = ln;
        off += ln;
        derive_key(body, key_ref, pos);
        return true;
    }
};

}  // namespace

extern "C" {

// Returns records written, or: -1 malformed input, -2 I/O error.
// Runs past max_in_memory records spill to spill_dir (the caller passes the
// output's directory, which must hold the output anyway; the system temp
// directory may be far smaller): each run file is made by mkstemp there and
// unlinked at once, so it lives only as an open handle and a crash leaves
// nothing behind.
int64_t ps_bam_sort(const char* in_path, const char* out_path,
                    const char* spill_dir,
                    const uint8_t* header_blob, int64_t header_len,
                    int32_t min_mapq, int32_t mapped_only,
                    int64_t max_in_memory, int32_t level) {
    FILE* fin = fopen(in_path, "rb");
    if (!fin) return -2;
    BamByteReader rd(fin);

    // skip the input BAM header (magic + text + ref dictionary)
    if (!rd.ensure(12) || std::memcmp(rd.data(), "BAM\x01", 4) != 0) {
        fclose(fin);
        return -1;
    }
    const int32_t l_text = rd.peek_i32(4);
    if (l_text < 0 || !rd.ensure(12 + size_t(l_text))) {
        fclose(fin);
        return -1;
    }
    rd.skip(8 + size_t(l_text));
    if (!rd.ensure(4)) { fclose(fin); return -1; }
    const int32_t n_ref = rd.peek_i32(0);
    rd.skip(4);
    for (int32_t r = 0; r < n_ref; ++r) {
        if (!rd.ensure(4)) { fclose(fin); return -1; }
        const int32_t l_name = rd.peek_i32(0);
        if (l_name < 0 || !rd.ensure(8 + size_t(l_name))) {
            fclose(fin);
            return -1;
        }
        rd.skip(8 + size_t(l_name));
    }

    std::vector<uint8_t> arena;
    std::vector<SortKey> keys;
    std::vector<FILE*> runs;
    uint64_t arrival = 0;
    bool bad = false, io_bad = false;

    // <spill_dir>/.<output's name>.sortrun.XXXXXX
    const char* slash = std::strrchr(out_path, '/');
    const std::string run_name =
        "/." + std::string(slash ? slash + 1 : out_path) + ".sortrun.XXXXXX";
    auto open_run = [&]() -> FILE* {
        std::string tmpl = std::string(spill_dir) + run_name;
        const int fd = mkstemp(&tmpl[0]);
        if (fd < 0) return nullptr;
        unlink(tmpl.c_str());
        FILE* rf = fdopen(fd, "w+b");
        if (!rf) close(fd);
        return rf;
    };

    auto spill_run = [&]() -> bool {
        std::sort(keys.begin(), keys.end(), key_less);
        FILE* rf = open_run();
        if (!rf) return false;
        std::vector<uint8_t> ob;
        ob.reserve(8 << 20);
        for (const SortKey& k : keys) {
            const uint32_t ln = k.len;
            const uint8_t* lp = reinterpret_cast<const uint8_t*>(&ln);
            ob.insert(ob.end(), lp, lp + 4);
            ob.insert(ob.end(), arena.data() + k.arena_off,
                      arena.data() + k.arena_off + ln);
            if (ob.size() >= (8 << 20)) {
                if (fwrite(ob.data(), 1, ob.size(), rf) != ob.size()) {
                    fclose(rf);
                    return false;
                }
                ob.clear();
            }
        }
        if ((!ob.empty() &&
             fwrite(ob.data(), 1, ob.size(), rf) != ob.size()) ||
            fflush(rf) != 0) {
            fclose(rf);
            return false;
        }
        rewind(rf);
        runs.push_back(rf);
        keys.clear();
        arena.clear();
        return true;
    };

    // ingest + filter
    while (true) {
        if (!rd.ensure(4)) {
            if (rd.bad || rd.avail() != 0) bad = true;  // truncated record
            break;
        }
        const int32_t bsz = rd.peek_i32(0);
        if (bsz < 32) { bad = true; break; }
        if (!rd.ensure(4 + size_t(bsz))) { bad = true; break; }
        const uint8_t* body = rd.data() + 4;
        uint16_t fl;
        std::memcpy(&fl, body + 14, 2);
        const bool unmapped = (fl & 0x4) != 0;
        const int32_t mapq = body[9];
        const bool drop = (mapped_only && unmapped) ||
            (min_mapq > 0 && !unmapped && mapq < min_mapq);
        if (!drop) {
            SortKey k;
            derive_key(body, k.key_ref, k.pos);
            k.arrival = arrival;
            k.arena_off = arena.size();
            k.len = uint32_t(bsz);
            arena.insert(arena.end(), body, body + bsz);
            keys.push_back(k);
            if (int64_t(keys.size()) >= max_in_memory) {
                if (!spill_run()) { io_bad = true; break; }
            }
        }
        ++arrival;
        rd.skip(4 + size_t(bsz));
    }
    fclose(fin);
    if (bad || io_bad) {
        for (FILE* rf : runs) fclose(rf);
        return bad ? -1 : -2;
    }

    FILE* fout = fopen(out_path, "wb");
    if (!fout) {
        for (FILE* rf : runs) fclose(rf);
        return -2;
    }
    BgzfSink sink(fout, level);
    sink.write(header_blob, size_t(header_len));

    int64_t n_out = 0;
    auto emit = [&](const uint8_t* body, uint32_t len) {
        const int32_t ln = int32_t(len);
        sink.write(reinterpret_cast<const uint8_t*>(&ln), 4);
        sink.write(body, len);
        ++n_out;
    };

    if (runs.empty()) {
        std::sort(keys.begin(), keys.end(), key_less);
        for (const SortKey& k : keys)
            emit(arena.data() + k.arena_off, k.len);
    } else {
        if (!keys.empty() && !spill_run()) {
            for (FILE* rf : runs) fclose(rf);
            fclose(fout);
            return -2;
        }
        std::vector<RunReader> readers;
        readers.reserve(runs.size());
        for (FILE* rf : runs) readers.emplace_back(rf);
        // ties break by run index = spill (arrival) order, like heapq.merge
        auto cmp = [&](size_t a, size_t b) {
            const RunReader& ra = readers[a];
            const RunReader& rb = readers[b];
            if (ra.key_ref != rb.key_ref) return ra.key_ref > rb.key_ref;
            if (ra.pos != rb.pos) return ra.pos > rb.pos;
            return a > b;
        };
        std::priority_queue<size_t, std::vector<size_t>, decltype(cmp)>
            heap(cmp);
        for (size_t i = 0; i < readers.size(); ++i)
            if (readers[i].advance()) heap.push(i);
        bool merge_bad = false;
        while (!heap.empty()) {
            const size_t i = heap.top();
            heap.pop();
            emit(readers[i].body, readers[i].len);
            if (readers[i].advance()) heap.push(i);
            else if (readers[i].bad) { merge_bad = true; break; }
        }
        for (FILE* rf : runs) fclose(rf);
        if (merge_bad) { fclose(fout); return -2; }
    }
    const bool ok = sink.close();
    if (fclose(fout) != 0 || !ok) return -2;
    return n_out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Gapped host tracebacks — the C++ twin of the numpy DP and Python walk in
// pipeline/align.py::host_tracebacks_batch (bit-identical, pinned by
// tests/test_torch_native_traceback.py). For each of G rows:
//   1. the score rows rows[i][r] = S[strand][prof][r][read[i]] (prof = i,
//      or len - 1 - i on strand 1; read bases clipped to 0..4) and the
//      reference window win[t] = ref[diag - w + t], N out of range;
//   2. the banded glocal affine-gap DP over the band = 2w + 1 diagonals,
//      int64, with the integer semantics of _banded_dp_batch: the NEG
//      sentinel, M only where best_prev > NEG / 2, Ix NEG in row 0 and in
//      the last diagonal, Iy as the prefix max
//      Iy[j] = max_{u<j} (M[u] + u*ge) - go - (j-1)*ge, NEG at j = 0;
//   3. the walk back from the first argmax of M[len - 1], with the tie order
//      of oracle/align.py::traceback_alignment (M > Iy > Ix out of M; a gap
//      closes into M on >=);
//   4. the run-length CIGAR, and NM = gap bases + the M segments' positions
//      where ref != read or either is N.
// Single-threaded on purpose: the stream's reader and writer need the other
// cores (ctypes releases the GIL for the call).
//   scores   int64 [2, ls, 5, 5]  S[strand][cycle][ref base][read base]
//   oriented int8  [G, lo]        genome-frame reads, lo >= max(lens)
//   lens, strands, diags int64 [G]
//   ref      int8  [ref_len]      packed reference codes
//   out: pos int64 [G] (diag - w + start_j), nm int32 [G], n_runs int32 [G],
//        run_ops uint8 / run_lens int32 [cap]: each row's runs (0 M, 1 I,
//        2 D) after the last row's, first op first
// A row this function cannot finish as numpy would — a strand other than
// 0 / 1, a length outside 1..min(lo, ls), a reference code outside 0..4, a
// walk that would leave its tables, an M segment outside [0, ref_len),
// runs past cap — gets n_runs = -1 and no runs: the caller leaves such a
// batch to the numpy path, which defines those cases. Returns the rows
// finished, or -1 on bad arguments.
// ---------------------------------------------------------------------------

namespace {

constexpr int64_t kNeg = -(int64_t(1) << 28);   // oracle/align.py NEG

enum : uint8_t { kOpM = 0, kOpI = 1, kOpD = 2 };

// One row's DP and walk over its score rows [len, 5] and window
// [len + band - 1]. M, X (Ix), Y (Iy): [len, band] scratch; ops gets the
// walk's ops last to first. False where numpy has to decide.
bool traceback_row(const int64_t* rows, const int64_t* win, int64_t len,
                   int64_t band, int64_t go, int64_t ge, int64_t* M,
                   int64_t* X, int64_t* Y, uint8_t* ops, int64_t cap,
                   int64_t* n_ops, int64_t* start_j) {
    for (int64_t i = 0; i < len; ++i) {
        const int64_t* sr = rows + i * 5;
        const int64_t* wi = win + i;
        int64_t* m = M + i * band;
        int64_t* x = X + i * band;
        int64_t* y = Y + i * band;
        for (int64_t j = 0; j < band; ++j) {
            const int64_t r = wi[j];
            if (i == 0) {
                m[j] = sr[r];
                x[j] = kNeg;
                continue;
            }
            const int64_t* mp = m - band;
            const int64_t* xp = x - band;
            const int64_t* yp = y - band;
            const int64_t bp = std::max(mp[j], std::max(xp[j], yp[j]));
            m[j] = bp > kNeg / 2 ? sr[r] + bp : kNeg;
            x[j] = j + 1 < band ? std::max(mp[j + 1] - go, xp[j + 1] - ge)
                                : kNeg;
        }
        y[0] = kNeg;
        int64_t cm = m[0];
        for (int64_t j = 1; j < band; ++j) {
            y[j] = cm - go - (j - 1) * ge;
            cm = std::max(cm, m[j] + j * ge);
        }
    }
    const int64_t* last = M + (len - 1) * band;
    int64_t j = 0;
    for (int64_t k = 1; k < band; ++k)
        if (last[k] > last[j]) j = k;
    int64_t i = len - 1, n = 0;
    uint8_t state = kOpM;
    for (;;) {
        if (n >= cap) return false;
        ops[n++] = state;
        if (state == kOpM) {
            if (i == 0) break;
            const int64_t at = (i - 1) * band + j;
            const int64_t prev = std::max(M[at], std::max(Y[at], X[at]));
            state = prev == M[at] ? kOpM : prev == Y[at] ? kOpD : kOpI;
            --i;
        } else if (state == kOpI) {
            if (i == 0 || j + 1 >= band) return false;
            const int64_t at = (i - 1) * band + j + 1;
            state = M[at] - go >= X[at] - ge ? kOpM : kOpI;
            --i;
            ++j;
        } else {
            if (j == 0) return false;
            const int64_t at = i * band + j - 1;
            state = M[at] - go >= Y[at] - ge ? kOpM : kOpD;
            --j;
        }
    }
    *n_ops = n;
    *start_j = j;
    return true;
}

}  // namespace

extern "C" {

int64_t ps_tracebacks_batch(
    const int64_t* scores, int64_t ls, const int8_t* oriented, int64_t lo,
    const int64_t* lens, const int64_t* strands, const int64_t* diags,
    const int8_t* ref, int64_t ref_len, int64_t G, int64_t w,
    int64_t gap_open, int64_t gap_extend, int64_t cap, int64_t* out_pos,
    int32_t* out_nm, int32_t* out_n_runs, uint8_t* run_ops,
    int32_t* run_lens) {
    if (G < 0 || ls < 1 || lo < 1 || w < 0 || cap < 0) return -1;
    const int64_t band = 2 * w + 1;
    const int64_t L = std::min(lo, ls);
    // a walk has len M or I ops and at most 2w + len - 1 D ops
    const int64_t ops_cap = 2 * (L + w);
    std::vector<int64_t> tables(static_cast<size_t>(3 * L * band));
    std::vector<int64_t> rows(static_cast<size_t>(5 * L));
    std::vector<int64_t> win(static_cast<size_t>(L + 2 * w));
    std::vector<uint8_t> ops(static_cast<size_t>(ops_cap));
    int64_t* M = tables.data();
    int64_t* X = M + L * band;
    int64_t* Y = X + L * band;
    int64_t done = 0, cursor = 0;
    for (int64_t g = 0; g < G; ++g) {
        out_n_runs[g] = -1;
        const int64_t len = lens[g], strand = strands[g];
        if (len < 1 || len > L || (strand != 0 && strand != 1)) continue;
        const int8_t* rd = oriented + g * lo;
        const int64_t* s = scores + strand * ls * 25;
        for (int64_t i = 0; i < len; ++i) {
            const int64_t prof = strand == 0 ? i : len - 1 - i;
            const int64_t c = std::min<int64_t>(std::max<int64_t>(rd[i], 0),
                                                4);
            for (int64_t r = 0; r < 5; ++r)
                rows[size_t(i * 5 + r)] = s[prof * 25 + r * 5 + c];
        }
        bool ok = true;
        const int64_t w0 = diags[g] - w;
        for (int64_t t = 0; t < len + 2 * w; ++t) {
            const int64_t at = w0 + t;
            const int64_t b = at >= 0 && at < ref_len ? ref[at] : 4;
            ok = ok && b >= 0 && b <= 4;
            win[size_t(t)] = b;
        }
        int64_t n_ops = 0, start_j = 0;
        if (!ok || !traceback_row(rows.data(), win.data(), len, band,
                                  gap_open, gap_extend, M, X, Y, ops.data(),
                                  ops_cap, &n_ops, &start_j))
            continue;
        const int64_t pos = w0 + start_j;
        int64_t n_runs = 0, nm = 0, ri = pos, qi = 0;
        for (int64_t k = n_ops - 1; k >= 0;) {   // first op to last
            const uint8_t op = ops[size_t(k)];
            int64_t run = 0;
            while (k >= 0 && ops[size_t(k)] == op) {
                ++run;
                --k;
            }
            if (cursor + n_runs >= cap) {
                ok = false;
                break;
            }
            run_ops[cursor + n_runs] = op;
            run_lens[cursor + n_runs] = int32_t(run);
            ++n_runs;
            if (op == kOpM) {
                if (ri < 0 || ri + run > ref_len) {
                    ok = false;
                    break;
                }
                for (int64_t t = 0; t < run; ++t) {
                    const int8_t rb = ref[ri + t], cb = rd[qi + t];
                    nm += (rb != cb) | (rb == 4) | (cb == 4);
                }
                ri += run;
                qi += run;
            } else {
                nm += run;
                (op == kOpI ? qi : ri) += run;
            }
        }
        if (!ok) continue;
        cursor += n_runs;
        out_pos[g] = pos;
        out_nm[g] = int32_t(nm);
        out_n_runs[g] = int32_t(n_runs);
        ++done;
    }
    return done;
}

}  // extern "C"
