#!/usr/bin/env python3
"""Compare two builds of the flash-attention kernels on one NVIDIA GPU.

``python3 chip_flash_ab.py OTHER.cu`` builds the package's
``kernels/flash_attention.cu`` and ``OTHER.cu`` (another version with the
same C interface, for example the parent commit's, from ``git show
PARENT:ray_shuffling_data_loader_tpu_torch/kernels/flash_attention.cu``;
a version that includes ``hopper.cuh`` needs its own copy of that header
beside it, as a quoted include is found there before ``kernels/``),
holds both against the plain PyTorch versions at ``chip_smoke.py``'s
attention shapes (within 2e-2), then times each kernel of each build at
the main shape (B=32, H=12, S=512, D=64, bf16, no bias; CUDA-graph device
time) in turns: other, package, package, other. Prints the card's name and
power limit, then one JSON line per check and per timing round. Needs
CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

import chip_smoke as cs

KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def main(other_source: str) -> int:
    if not torch.cuda.is_available():
        print("chip_flash_ab: CUDA is not available", file=sys.stderr)
        return 1
    from ray_shuffling_data_loader_tpu_torch.kernels import build
    from ray_shuffling_data_loader_tpu_torch.ops import flash_attention as fa

    print(cs.nvidia_smi_line(), flush=True)
    libs = {"package": build.flash_library(),
            "other": ctypes.CDLL(build._compile("rsdl_torch_flash_other",
                                                other_source))}
    libs["other"].rsdl_cuda_error_string.argtypes = [ctypes.c_int]
    libs["other"].rsdl_cuda_error_string.restype = ctypes.c_char_p
    build._bind_flash(libs["other"])

    g = torch.Generator(device="cuda").manual_seed(2)
    b, h, s, d = cs.ATT_B, cs.ATT_H, cs.ATT_S, cs.ATT_D
    try:
        for name, lib in libs.items():
            build._libs["rsdl_torch_flash"] = lib
            cs.emit({"build": name, "max_abs_err": {
                "main": cs._check_case(fa, "main", *cs._attention_inputs(
                    g, b, h, s, s, d, masked=False)),
                "main_bias": cs._check_case(fa, "main_bias",
                                            *cs._attention_inputs(
                                                g, b, h, s, s, d,
                                                masked=True)),
                "ragged": cs._check_case(fa, "ragged", *cs._attention_inputs(
                    g, 4, 3, 500, 300, 32, masked=True))}})
        q, k, v, do, _ = cs._attention_inputs(g, b, h, s, s, d, masked=False)
        out, lse = fa.flash_fwd(q, k, v)
        delta = (do.float() * out.float()).sum(-1)
        args = {"flash_fwd": [(q, k, v)],
                "flash_dq": [(q, k, v, None, do, lse, delta)],
                "flash_dkv": [(q, k, v, None, do, lse, delta)]}
        for name in ("other", "package", "package", "other"):
            build._libs["rsdl_torch_flash"] = libs[name]
            cs.emit({"build": name, "ms": {
                kernel: cs.device_ms(getattr(fa, kernel), args[kernel], 20)
                for kernel in KERNELS}})
    finally:
        build._libs["rsdl_torch_flash"] = libs["package"]
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
