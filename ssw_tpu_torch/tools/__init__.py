"""Measurement tools of the port.  Three have a hand-written CUDA kernel
(ssw_tpu_torch/csrc/) and a plain PyTorch twin:

    python -m ssw_tpu_torch.tools.probe_swar   # dependent max chains
    python -m ssw_tpu_torch.tools.probe_i16    # int16 / DPX op probes
    python -m ssw_tpu_torch.tools.kernel_lab full nostore ...

Their launches are counted in tools/_common.LAUNCHES, apart from the main
path's ops/cuda_sw.LAUNCHES.  Two run the main path at a BASELINE
configuration's full size, the counterparts of the JAX package's tools:

    python -m ssw_tpu_torch.tools.run_config4_full  # config 4, 100k reads
    python -m ssw_tpu_torch.tools.bench_protein     # config 2 at scale

They all run on the card and raise without one; `--device cpu`
(device="cpu" from Python) runs the plain twins instead, for correctness
only.
"""
