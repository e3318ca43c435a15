"""Streaming alignment with batch-granular checkpoint/resume.

A copy of parasuite_tpu/pipeline/stream.py (that package imports jax when
it is imported). Two changes: the profile counts come to the host with
.cpu() instead of jax.device_get, and the results stay on the device until
engine.to_host fetches them; and the manifest carries the partial profile
counts and indel counts itself (keys "counts" and "indels"), so that one
atomic rename commits a checkpoint. The original commits them as three
files one after the other, and a kill between the counts file and the
manifest leaves counts one batch ahead of the manifest: the resumed run
then counts that batch twice. The side files are still written (the
multi-host merge and the original's resume read them), and a manifest
without the keys (one the original wrote) falls back to them.

SURVEY.md §5 failure detection / checkpoint-resume: the reference's only
recovery is "every stage output is a file, rerun the stage by hand". Here the
50M-read configs record per-shard progress — the last committed batch index,
running SAM record count, and (for pass 1) the partial profile count matrix —
so a host failure reruns only unfinished batches. No elastic resharding: this
is a bounded batch job (SURVEY.md §5), restartability is per (shard, batch).

Layout next to the output SAM shard:
    <out>.progress.json   {batches_done, records, batch_records, sam_bytes,
                           cfg_hash, complete; profile passes also counts,
                           indels}
    <out>.counts.npy      partial int64 [L, 4, 4] (profile passes only)

Determinism note: a resumed run produces byte-identical output to an
uninterrupted one because batch boundaries are fixed by (batch_size,
shard layout), never by timing. Crash safety: `sam_bytes` records the
committed byte offset of the SAM file at checkpoint time; on resume the
file is truncated back to it, so a crash landing between a record flush
and the manifest save (file ahead of manifest) cannot duplicate records.
`batch_records` (records emitted per local batch) is what lets the
multi-host merge interleave shard bodies by GLOBAL batch index — the
property that makes merged SAM bytes identical at any host count
(SURVEY.md §4.5).
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

from parasuite_tpu_torch.config import AlignConfig
from parasuite_tpu_torch.io.fastq import iter_fastq_batches
from parasuite_tpu_torch.io.sam import sam_header
from parasuite_tpu_torch.utils.runlog import NULL_LOG, bind, count, span


def _cfg_hash(cfg: AlignConfig) -> str:
    return hashlib.sha256(cfg.to_json().encode()).hexdigest()[:16]


class StreamCheckpoint:
    def __init__(self, out_sam, cfg: AlignConfig):
        self.out_sam = Path(out_sam)
        self.manifest = Path(str(out_sam) + ".progress.json")
        self.counts_path = Path(str(out_sam) + ".counts.npy")
        self.indels_path = Path(str(out_sam) + ".indels.npz")
        self.cfg_hash = _cfg_hash(cfg)

    def load(self) -> dict | None:
        if not self.manifest.exists():
            return None
        state = json.loads(self.manifest.read_text())
        if state.get("cfg_hash") != self.cfg_hash:
            return None  # config changed: restart from scratch
        if "sam_bytes" not in state or "batch_records" not in state:
            return None  # pre-v2 manifest: no committed offset -> restart
        return state

    def save(self, batches_done: int, records: int, complete: bool = False,
             counts: np.ndarray | None = None, profiled: int = 0,
             indels: tuple | None = None, sam_bytes: int = 0,
             batch_records: list | None = None) -> None:
        if counts is not None:
            tmp = str(self.counts_path) + ".tmp.npy"  # np.save appends .npy
            np.save(tmp, counts)
            os.replace(tmp, self.counts_path)
        if indels is not None:
            ins, dels, n_gapped = indels
            tmp = str(self.indels_path) + ".tmp.npz"
            np.savez(tmp, ins=ins, dels=dels,
                     n_gapped=np.int64(n_gapped))
            os.replace(tmp, self.indels_path)
        state = {
            "batches_done": batches_done, "records": records,
            "profiled": profiled, "cfg_hash": self.cfg_hash,
            "sam_bytes": sam_bytes,
            "batch_records": batch_records if batch_records is not None else [],
            "complete": complete}
        # the counts ride in the manifest too: its rename is the commit
        if counts is not None:
            state["counts"] = np.asarray(counts).tolist()
        if indels is not None:
            state["indels"] = {"ins": np.asarray(indels[0]).tolist(),
                               "dels": np.asarray(indels[1]).tolist(),
                               "n_gapped": int(indels[2])}
        tmp = str(self.manifest) + ".tmp"
        Path(tmp).write_text(json.dumps(state))
        os.replace(tmp, self.manifest)

    def load_counts(self, shape, state: dict | None = None) -> np.ndarray:
        """The partial counts of the checkpoint `state` (a loaded
        manifest): its own when it carries them, else the side file."""
        if state is not None and "counts" in state:
            return np.asarray(state["counts"], dtype=np.int64).reshape(shape)
        if self.counts_path.exists():
            return np.load(self.counts_path)
        return np.zeros(shape, dtype=np.int64)

    def load_indels(self, L: int, state: dict | None = None) -> tuple:
        if state is not None and "indels" in state:
            d = state["indels"]
            return (np.asarray(d["ins"], dtype=np.int64),
                    np.asarray(d["dels"], dtype=np.int64),
                    int(d["n_gapped"]))
        if self.indels_path.exists():
            z = np.load(self.indels_path)
            return (z["ins"].astype(np.int64), z["dels"].astype(np.int64),
                    int(z["n_gapped"]))
        return (np.zeros(L, dtype=np.int64), np.zeros(L, dtype=np.int64), 0)


def _bam_header_bytes(header_text: str, ref) -> bytes:
    """BAM magic + header text + reference dictionary for `ref` (payload
    bytes — BGZF compression happens in the sink like any record)."""
    import struct

    text = header_text.encode("ascii")
    out = bytearray(b"BAM\x01" + struct.pack("<i", len(text)) + text
                    + struct.pack("<i", len(ref.names)))
    for i, nm in enumerate(ref.names):
        nb = nm.encode("ascii") + b"\0"
        out += struct.pack("<i", len(nb)) + nb
        out += struct.pack("<i", int(ref.chrom_len(i)))
    return bytes(out)


class _BamSink:
    """Writer-thread sink for direct BAM output: buffers BAM record bytes
    (native formatter via write_block; rare gapped/junction records arrive
    as SAM text via write and are encoded here) and BGZF-compresses on
    flush — in C++ when the native library is present, else the Python
    BgzfWriter framing. flush() is called at every checkpoint boundary so
    fh.tell() is always a valid BGZF prefix (resume contract)."""

    def __init__(self, fh, ref, level: int = 6):
        from parasuite_tpu_torch import native

        self._fh = fh
        self._buf = bytearray()
        self.level = level
        self._rid_of = {nm: i for i, nm in enumerate(ref.names)}
        self._native = native.available()

    def write(self, line: str) -> None:
        from parasuite_tpu_torch.io.bam import encode_bam_record

        self._buf += encode_bam_record(line.split("\t"), self._rid_of)

    def write_block(self, data: bytes) -> None:
        self._buf += data

    def flush(self) -> None:
        if not self._buf:
            return
        data = bytes(self._buf)
        self._buf.clear()
        if self._native:
            from parasuite_tpu_torch import native

            self._fh.write(native.bgzf_compress(data, self.level))
        else:
            import zlib

            from parasuite_tpu_torch.io.bam import _MAX_BLOCK
            import struct
            for i in range(0, len(data), _MAX_BLOCK):
                chunk = data[i : i + _MAX_BLOCK]
                co = zlib.compressobj(self.level, zlib.DEFLATED, -15)
                comp = co.compress(chunk) + co.flush()
                total = 12 + 6 + len(comp) + 8
                hdr = struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0,
                                  0xFF, 6, 66, 67, 2, total - 1)
                self._fh.write(hdr + comp + struct.pack(
                    "<II", zlib.crc32(chunk), len(chunk)))


def streaming_align(engine, fastq, out_sam, *, resume: bool = False,
                    with_profile_counts: bool = False, log=NULL_LOG,
                    write_header: bool = True, command_line: str = "",
                    stride_shards: int = 1, shard_index: int = 0,
                    checkpoint_every: int = 1, indel_out: dict | None = None,
                    depth: int = 8, stats_out: dict | None = None):
    """Align a FASTQ stream to a SAM shard with resume support.

    Returns (n_records, counts int64 [L,4,4] or None, n_profiled). Batch
    boundaries are fixed by cfg.batch_size and the shard layout, so
    restarting cannot change output bytes. With profile counts enabled,
    indel events from the gapped tracebacks (already computed for SAM
    CIGARs) are accumulated too; pass indel_out={} to receive
    {"ins", "dels", "n_gapped"} (SURVEY.md §2 component 3 indel rates).

    depth is THE in-flight knob (VERDICT r3 weak #4): it bounds the number
    of device batches dispatched but not yet drained AND sizes both thread
    queues, so the reader can run depth batches ahead and a slow writer
    stalls the main thread at depth — one knob, one window. stats_out (if a
    dict) receives high-water marks {"pending_high", "q_in_high",
    "q_out_high"} so tests can assert the window exists as documented.

    A log that records (utils/runlog.py, record=True) gets each thread's
    spans a batch: reader.parse and reader.wait (the put into the full
    input queue); main.wait_reads, step.dispatch and engine.to_host (with
    the engine's own spans inside them) and main.wait_writer, and once a
    call main.wait_drain (the writer's backlog at the end, under the last
    batch's index); writer.wait,
    writer.emit and writer.commit; and the counters reads and
    writer.sam_bytes. With profile counts, main also has engine.profile a
    batch after engine.to_host (the device counts' copy to the host and
    engine.accumulate_profile_host), with the counters profile.reads and
    profile.gapped_rows, which add up to the profile's n_reads and
    n_gapped. The align.batch event is built only for a log that
    writes somewhere (`live`; a log without the attribute counts as live).
    """
    cfg = engine.cfg
    ckpt = StreamCheckpoint(out_sam, cfg)
    state = ckpt.load() if resume else None
    if state is not None and not Path(out_sam).exists():
        state = None  # manifest without its SAM: restart
    start_batch = state["batches_done"] if state else 0
    n_records = state["records"] if state else 0
    n_profiled = state.get("profiled", 0) if state else 0
    batch_records: list = (list(state["batch_records"][:start_batch])
                           if state else [])
    counts = (ckpt.load_counts((cfg.max_read_len, 4, 4), state)
              if (with_profile_counts and state) else
              np.zeros((cfg.max_read_len, 4, 4), dtype=np.int64))
    if with_profile_counts and state:
        ins, dels, n_gapped = ckpt.load_indels(cfg.max_read_len, state)
    else:
        ins = np.zeros(cfg.max_read_len, dtype=np.int64)
        dels = np.zeros(cfg.max_read_len, dtype=np.int64)
        n_gapped = 0
    if state and state.get("complete"):
        log.event("align.skip", reason="already complete", records=n_records)
        if indel_out is not None and with_profile_counts:
            indel_out.update(ins=ins, dels=dels, n_gapped=n_gapped)
        return n_records, (counts if with_profile_counts else None), n_profiled

    # binary mode: fh.tell() is an exact byte offset (the committed-offset
    # crash-safety contract needs real bytes, not text-mode cookies). BAM
    # outputs stream BGZF blocks directly (no .tmp.sam double pass —
    # VERDICT r3 weak #3): block boundaries are cut at every checkpoint
    # flush, so the committed offset is always a valid BGZF prefix and the
    # truncate-on-resume contract carries over unchanged.
    bam_out = str(out_sam).endswith(".bam")
    mode = "r+b" if state else "wb"
    recording = getattr(log, "recording", False)
    live = getattr(log, "live", True)
    if recording:
        log.begin_call()
    with open(out_sam, mode) as fh:

        class _FhWriter:
            def write(self, line):
                fh.write(line.encode("ascii") + b"\n")

            def write_block(self, data):
                # native formatter emits raw bytes; str kept for tools
                fh.write(data if isinstance(data, bytes)
                         else data.encode("ascii"))

            def flush(self):
                pass

        writer = _BamSink(fh, engine.sam_ref) if bam_out else _FhWriter()
        emit = engine.emit_bam if bam_out else engine.emit_sam
        if state:
            # crash window: records may have been flushed AFTER the last
            # manifest save -> truncate back to the committed offset so a
            # re-emitted batch cannot duplicate records
            fh.truncate(state["sam_bytes"])
            fh.seek(state["sam_bytes"])
        elif write_header:
            htext = sam_header(engine.sam_ref, command_line=command_line)
            if bam_out:
                writer.write_block(_bam_header_bytes(htext, engine.sam_ref))
                writer.flush()
            else:
                fh.write(htext.encode("ascii"))
        batch_idx = 0

        # --- 3-stage threaded pipeline (SURVEY.md §7 hard part 3) ---
        # reader thread: FASTQ -> batches (C++ scanner releases the GIL)
        # main thread:   device dispatch + result fetch + tracebacks
        # writer thread: SAM formatting (C++ releases the GIL) + file I/O +
        #                checkpoints, strictly in batch order (FIFO queue)
        # Steady-state throughput = the slowest stage, not their sum.
        import queue
        import threading

        q_in: queue.Queue = queue.Queue(maxsize=depth)
        q_out: queue.Queue = queue.Queue(maxsize=depth)
        errors: list = []
        wstate = {"n_records": n_records, "final_bytes": 0}
        hw = {"pending_high": 0, "q_in_high": 0, "q_out_high": 0}

        def reader():
            try:
                with bind(log, "reader"):
                    batches = iter_fastq_batches(
                        fastq, cfg.batch_size, cfg.max_read_len,
                        stride_shards=stride_shards, shard_index=shard_index)
                    k = 0
                    while True:
                        k += 1
                        with span("reader.parse", batch=k) as sp:
                            b = next(batches, None)
                            if b is None:
                                sp.drop()
                                return
                            count("reads", b.n_real)
                        with span("reader.wait", batch=k):
                            q_in.put(b)
                        hw["q_in_high"] = max(hw["q_in_high"], q_in.qsize())
                        if errors:
                            return
            except BaseException as e:  # propagate to main
                errors.append(e)
            finally:
                q_in.put(None)

        def writer_loop():
            try:
                with bind(log, "writer"):
                    written = fh.tell() if recording else 0
                    idx = start_batch
                    while True:
                        with span("writer.wait", batch=idx + 1) as sp:
                            item = q_out.get()
                            if item is None:
                                sp.drop()
                                return
                        batch, host, idx, snap = item
                        with span("writer.emit", batch=idx):
                            emit(batch, host, writer)
                        with span("writer.commit", batch=idx):
                            # BAM: cut a BGZF block at the boundary
                            writer.flush()
                            fh.flush()
                            wstate["n_records"] += batch.n_real
                            batch_records.append(batch.n_real)
                            if (idx - start_batch) % checkpoint_every == 0:
                                ckpt.save(idx, wstate["n_records"],
                                          profiled=snap["profiled"],
                                          counts=snap["counts"],
                                          indels=snap["indels"],
                                          sam_bytes=fh.tell(),
                                          batch_records=batch_records)
                            if live:
                                log.event("align.batch", batch=idx,
                                          reads=batch.n_real,
                                          mapped=int(host.mapped[
                                              :batch.n_real].sum()),
                                          records=wstate["n_records"])
                            if recording:
                                written, before = fh.tell(), written
                                count("writer.sam_bytes", written - before)
            except BaseException as e:
                errors.append(e)
                while True:  # drain so main never blocks on a full queue
                    if q_out.get() is None:
                        return

        counts_from_host = getattr(engine, "counts_from_host", False)

        def profile(batch, host, c) -> tuple[int, int]:
            """The profile accounting of one batch (with_profile_counts):
            the step's fused counts, if it made any, then the engine's own
            host share -> (reads profiled, rows counted from their
            CIGARs)."""
            if c is not None:
                counts[...] += c.cpu().numpy().astype(np.int64)
            return engine.accumulate_profile_host(batch, host, counts, ins,
                                                  dels)

        def drain(pend):
            """Finish one dispatched batch on the main thread (fetch +
            tracebacks, and a profile pass's accounting) and hand it to the
            writer. The checkpoint snapshot is copied HERE so a manifest can
            never include profile counts from a batch whose records are not
            yet on disk."""
            nonlocal n_profiled, n_gapped
            batch, res, c, idx = pend
            with span("engine.to_host", batch=idx):
                host = engine.to_host(batch, res)
            if with_profile_counts:
                with span("engine.profile", batch=idx):
                    dp, dg = profile(batch, host, c)
                    count("profile.reads", dp)
                    count("profile.gapped_rows", dg)
                n_profiled += dp
                n_gapped += dg
            snap = {"profiled": n_profiled,
                    "counts": counts.copy() if with_profile_counts else None,
                    "indels": ((ins.copy(), dels.copy(), n_gapped)
                               if with_profile_counts else None)}
            with span("main.wait_writer", batch=idx):
                q_out.put((batch, host, idx, snap))
            hw["q_out_high"] = max(hw["q_out_high"], q_out.qsize())

        t_read = threading.Thread(target=reader, daemon=True)
        t_write = threading.Thread(target=writer_loop, daemon=True)
        t_read.start()
        t_write.start()
        # keep several batches in flight: the graphed steps of later
        # batches run on the card while this thread finishes earlier ones
        # on the host
        from collections import deque
        pending: deque = deque()
        saw_eof = False
        with bind(log, "main"):
            while not errors:
                with span("main.wait_reads", batch=batch_idx + 1) as sp:
                    batch = q_in.get()
                    if batch is None:
                        sp.drop()
                if batch is None:
                    saw_eof = True
                    break
                if batch_idx < start_batch:  # committed before restart
                    batch_idx += 1
                    continue
                with span("step.dispatch", batch=batch_idx + 1):
                    if getattr(engine, "supports_packed", False):
                        # wire-packed step; profile counts fused into the
                        # same call (unless the engine counts from emitted
                        # records host-side)
                        want_c = with_profile_counts and not counts_from_host
                        out = engine.align_device_packed(
                            batch.codes, batch.lengths, with_counts=want_c)
                        res, c = out if want_c else (out, None)
                    else:
                        res = engine.align_device(batch.codes, batch.lengths)
                        c = (engine.profile_counts_device(
                            batch.codes, batch.lengths, res)
                             if with_profile_counts and not counts_from_host
                             else None)
                batch_idx += 1
                pending.append((batch, res, c, batch_idx))
                hw["pending_high"] = max(hw["pending_high"], len(pending))
                if len(pending) >= depth:
                    drain(pending.popleft())
            while pending and not errors:
                drain(pending.popleft())
            # the end of the call: the writer finishes its backlog
            with span("main.wait_drain", batch=batch_idx):
                q_out.put(None)
                t_write.join()
        while not saw_eof:  # unblock the reader if it is mid-put (error path)
            saw_eof = q_in.get() is None
        t_read.join()
        if errors:
            raise errors[0]
        n_records = wstate["n_records"]
        writer.flush()
        final_bytes = fh.tell()
        if bam_out:
            # EOF marker AFTER the committed offset: truncate-on-resume cuts
            # it off and the stream stays appendable; complete runs carry it
            from parasuite_tpu_torch.io.bam import BGZF_EOF

            fh.write(BGZF_EOF)
        if stats_out is not None:
            stats_out.update(hw)
    ckpt.save(batch_idx, n_records, complete=True, profiled=n_profiled,
              counts=counts if with_profile_counts else None,
              indels=(ins, dels, n_gapped) if with_profile_counts else None,
              sam_bytes=final_bytes, batch_records=batch_records)
    if indel_out is not None:
        indel_out.update(ins=ins, dels=dels, n_gapped=n_gapped)
    log.event("align.done", records=n_records, batches=batch_idx,
              xa_dropped=int(getattr(engine, "xa_dropped", 0)))
    return n_records, (counts if with_profile_counts else None), n_profiled
