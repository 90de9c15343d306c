#!/usr/bin/env python3
"""The DLRM ``mlperf`` step under the two device bindings and the Torch
binding, in turns within one process on one GPU: ``python3
chip_rebatch_ab.py [--epochs N] TURN...``.

Each TURN is ``bulk`` or ``per_batch``, optionally with ``+nowatchdog``
(``runtime_policy={"watchdog": False}``) or ``+serial``
(``device_double_buffer`` off), or ``torch`` (host batches from
``TorchShufflingDataset`` moved with ``.to("cuda")``, through
``chip_smoke._torch_binding_turn``, the smoke's ``torch_binding``
phase); the others go through ``chip_smoke._rebatch_turn`` (the
smoke's ``rebatch`` phase). Every turn trains a fresh model from the
same seed on the same 2,000,000 generated rows. Prints one JSON line
per turn: the step's median ms, ``stall_pct``, rows/s, the fill, whether
its batch digests equal the first turn's, and the first micro-step whose
loss differs from the first turn's (null: bit for bit); then the card's
name and power limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import torch

import chip_smoke as sm

VARIANTS = {"": {}, "nowatchdog": {"runtime_policy": {"watchdog": False}},
            "serial": {"runtime_policy": {"device_double_buffer": False}}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("turns", nargs="+")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_rebatch_ab: CUDA is not available", file=sys.stderr)
        return 1
    from ray_shuffling_data_loader_tpu_torch.kernels import build
    from ray_shuffling_data_loader_tpu_torch.ops import embedding as emb

    torch.backends.cuda.matmul.allow_tf32 = False
    build.gather_library()
    first = None
    with tempfile.TemporaryDirectory(prefix="rsdl-rebatch-ab-") as tmp:
        files, _ = sm.dlrm_files(tmp)
        for turn in args.turns:
            binding, _, variant = turn.partition("+")
            if binding == "torch":
                line, digests, losses = sm._torch_binding_turn(
                    emb, files, args.epochs)
            else:
                line, digests, losses = sm._rebatch_turn(
                    emb, files, binding, args.epochs, **VARIANTS[variant])
            if first is None:
                first = (digests, losses)
            differ = (losses != first[1]).nonzero()
            print(json.dumps({
                "turn": turn, "step_ms_median": line["step_ms_median"],
                "stall_pct": line["stall_pct"],
                "rows_per_s": line["rows_per_s"],
                "fill_s": line["fill_s"],
                "digests_equal_first": bool(torch.equal(digests, first[0])),
                "first_loss_differing_step": (int(differ[0]) if len(differ)
                                              else None),
                "max_abs_loss_diff": float((losses - first[1]).abs().max()),
            }), flush=True)
    print(sm.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
