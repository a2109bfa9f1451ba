"""Measurement tools of the port, each an entry point with a hand-written
CUDA kernel (ssw_tpu_torch/csrc/) and a plain PyTorch twin:

    python -m ssw_tpu_torch.tools.probe_swar   # dependent max chains
    python -m ssw_tpu_torch.tools.probe_i16    # int16 / DPX op probes
    python -m ssw_tpu_torch.tools.kernel_lab full nostore ...

They run on the card and raise without one; `--device cpu` (device="cpu"
from Python) runs the plain twins instead, for correctness only.  Their
launches are counted in tools/_common.LAUNCHES, apart from the main path's
ops/cuda_sw.LAUNCHES.
"""
