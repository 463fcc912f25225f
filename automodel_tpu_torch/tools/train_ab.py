"""Time the MoE training phases of several checkouts in alternation on one
card.

Runs ``chip_smoke.train_phase`` for the ``--phases`` chosen (default
``sft_moe``, Qwen3-30B-A3B at published widths and 4 layers through the
SFT recipe, then ``sft_moe_fp8``, the same with int8 quantized compute;
also ``sft_deepseek``, DeepSeek-V2-Lite at 4 layers) of each checkout in
a fresh process per run, in the order A B ... B A (each checkout twice a
round), ``--rounds`` times, so that a drift of the card or the host weighs
on all alike.  Prints every run's ``*_run``, ``profile`` and first-step
lines as they come, then one ``train_ab`` JSON line with, per checkout
and phase, the readings in run order (the first step's loss twice and its
gradient's relative L2 between two kernel runs among them)::

    python -m automodel_tpu_torch.tools.train_ab <checkout> <checkout> ... \
        [--phases sft_deepseek]

Needs a card; each checkout builds its kernels at first use, in its first
run (outside the timed steps).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = ("sft_moe", "sft_moe_fp8", "sft_deepseek")
# each phase's call; ``r`` holds the reports made so far in the process
_CALLS = {
    "sft_moe": "chip_smoke.train_phase('sft_moe', chip_smoke.MOE_YAML)",
    "sft_moe_fp8": ("chip_smoke.train_phase('sft_moe_fp8', "
                    "chip_smoke.MOE_YAML, ['--fp8.enabled', 'true', "
                    "'--fp8.dtype', 'int8'], bf16=r.get('sft_moe'))"),
    "sft_deepseek": ("chip_smoke.train_phase('sft_deepseek', "
                     "chip_smoke.LITE_YAML)"),
}


def _program(phases) -> str:
    lines = ["import torch, chip_smoke",
             "torch.backends.cuda.matmul.allow_tf32 = False",
             "torch.backends.cudnn.allow_tf32 = False", "r = {}"]
    for p in phases:
        lines += [f"r[{p!r}] = {_CALLS[p]}", "torch.cuda.empty_cache()"]
    return "\n".join(lines)


def run_once(checkout: str, timeout: float, phases=PHASES[:2]) -> dict:
    """The phases in a fresh process from ``checkout``; returns their
    ``*_run`` reports, ``profile`` windows and first-step checks by
    phase, or raises with the process's last lines if it failed."""
    proc = subprocess.run([sys.executable, "-c", _program(phases)],
                          cwd=checkout, capture_output=True, text=True,
                          timeout=timeout)
    got = {p: {} for p in phases}
    for line in proc.stdout.splitlines():
        tag, _, rest = line.partition(" ")
        if tag in {f"{p}_run" for p in phases}:
            got[tag[:-len("_run")]]["run"] = json.loads(rest)
        elif tag == "profile":
            rep = json.loads(rest)
            phase = rep["window"].rsplit("_b", 1)[0]
            if phase in got:
                got[phase]["profile"] = rep
        elif tag in got and rest.startswith("first step: "):
            got[tag]["first_step"] = json.loads(rest[len("first step: "):])
        else:
            continue
        print(f"[{checkout}] {line[:2000]}", flush=True)
    if proc.returncode != 0 or any("run" not in g for g in got.values()):
        tail = "\n".join((proc.stdout + proc.stderr).splitlines()[-20:])
        raise RuntimeError(f"train phases in {checkout} failed "
                           f"(rc {proc.returncode}):\n{tail}")
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+", help="checkouts, A B ...")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of A B ... B A (default 1)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds for one run (default 600)")
    ap.add_argument("--phases", default=",".join(PHASES[:2]),
                    help=f"comma-separated, of {PHASES} (default "
                         f"{','.join(PHASES[:2])})")
    args = ap.parse_args(argv)
    phases = tuple(args.phases.split(","))
    if not set(phases) <= set(PHASES):
        ap.error(f"--phases {args.phases}: not in {PHASES}")
    dirs = [os.path.abspath(d) for d in args.checkouts]
    got = {d: [] for d in dirs}
    for _ in range(args.rounds):
        for d in dirs + dirs[::-1]:
            got[d].append(run_once(d, args.timeout, phases))
    summary = {}
    for d, reps in got.items():
        summary[d] = {p: dict(
            step_ms=[r[p]["run"]["step_ms"] for r in reps],
            wall_s=[r[p]["run"]["wall_s"] for r in reps],
            device_ms_per_step=[r[p]["profile"]["device_ms_per_step"]
                                for r in reps],
            elementwise_and_copy_ms_per_step=[
                r[p]["profile"]["ms_per_step_by_kind"][
                    "elementwise_and_copy"] for r in reps],
            kernels_per_step=[r[p]["profile"]["kernels_per_step"]
                              for r in reps],
            peak_mem_bytes=[r[p]["run"].get("peak_mem_bytes")
                            for r in reps],
            first_step_losses=[r[p].get("first_step", {}).get("losses")
                               for r in reps],
            first_step_grad_rel_l2_kernel_vs_kernel=[
                r[p].get("first_step", {}).get(
                    "grad_rel_l2_kernel_vs_kernel") for r in reps])
        for p in phases}
    print("train_ab " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
