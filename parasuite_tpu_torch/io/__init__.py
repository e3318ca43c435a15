from parasuite_tpu_torch.io.fasta import read_fasta, write_fasta  # noqa: F401
from parasuite_tpu_torch.io.fastq import read_fastq, write_fastq, iter_fastq_batches  # noqa: F401
from parasuite_tpu_torch.io.batch import ReadBatch  # noqa: F401
