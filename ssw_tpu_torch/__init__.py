"""ssw_tpu_torch — the striped Smith-Waterman engine on PyTorch and CUDA.

A port of the JAX package `ssw_tpu` (kept in the repository as the frozen
reference) to one NVIDIA H100.  It imports neither JAX nor anything of
`ssw_tpu`: the host modules it shares in spirit are its own copies.

Layers:
  core/      encodings, substitution matrices, CIGAR codec, numpy oracle
  ops/       plain PyTorch DP (scan_sw), CUDA kernel wrappers (cuda_sw),
             kernel build/load (_kernels), host banded traceback (banded)
  csrc/      the hand-written CUDA kernels (sm_90a)
  native/    host C++ traceback and FASTX reader (g++ at first use)
  io/        FASTA/FASTQ reader, SAM + BLAST-like writers
  pipeline   ssw_align-equivalent orchestration (forward -> reverse -> CIGAR)
  cli        `ssw_test`-compatible command line driver (ref: src/main.c)

Entry points run on the CUDA device unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
