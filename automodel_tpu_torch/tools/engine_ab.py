"""Time the serving engine of two checkouts in alternation on one card.

Runs ``chip_smoke.engine_phase()`` of each checkout (Llama-3.2-1B at full
width through ``DecodeEngine``: its first-step check, the timed
``bf16_kv`` and ``int8_kv`` runs and two profiled windows) in a fresh
process per run, in the order A B B A, ``--rounds`` times, so that a
drift of the card or the host weighs on both alike.  Prints every run's
``engine_run`` and ``profile`` lines as they come, then one ``engine_ab``
JSON line with, per checkout, the readings in run order::

    python -m automodel_tpu_torch.tools.engine_ab --a . --b <other checkout>

Needs a card; each process builds the checkout's paged-decode kernel at
first use (outside the timed runs).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = ("import torch, chip_smoke; "
        "torch.backends.cuda.matmul.allow_tf32 = False; "
        "torch.backends.cudnn.allow_tf32 = False; "
        "chip_smoke.engine_phase()")


def run_once(checkout: str, timeout: float) -> dict:
    """One ``engine_phase`` in a fresh process from ``checkout``; returns
    its ``engine_run`` reports by run name and the ``profile`` reports by
    window, or raises with the process's last lines if it failed."""
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=checkout,
                          capture_output=True, text=True, timeout=timeout)
    runs, windows = {}, {}
    for line in proc.stdout.splitlines():
        if line.startswith("engine_run "):
            rep = json.loads(line[len("engine_run "):])
            runs[rep["run"]] = rep
        elif line.startswith("profile "):
            rep = json.loads(line[len("profile "):])
            windows[rep["window"]] = rep
        else:
            continue
        print(f"[{checkout}] {line}", flush=True)
    if proc.returncode != 0 or "bf16_kv" not in runs:
        tail = "\n".join((proc.stdout + proc.stderr).splitlines()[-20:])
        raise RuntimeError(f"engine_phase in {checkout} failed "
                           f"(rc {proc.returncode}):\n{tail}")
    return dict(runs=runs, windows=windows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="first checkout")
    ap.add_argument("--b", required=True, help="second checkout")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of A B B A (default 2)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds for one run (default 300)")
    args = ap.parse_args(argv)
    dirs = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    got = {"a": [], "b": []}
    for _ in range(args.rounds):
        for key in ("a", "b", "b", "a"):
            got[key].append(run_once(dirs[key], args.timeout))
    summary = {}
    for key, reps in got.items():
        summary[key] = dict(
            checkout=dirs[key],
            decode_tok_s=[r["runs"]["bf16_kv"]["decode_tok_s"]
                          for r in reps],
            int8_decode_tok_s=[r["runs"]["int8_kv"]["decode_tok_s"]
                               for r in reps],
            decode_w1_host_ms_per_step=[
                r["windows"]["decode_w1"]["host_ms_per_step"] for r in reps],
            decode_w1_device_ms_per_step=[
                r["windows"]["decode_w1"]["device_ms_per_step"]
                for r in reps],
            mixed_w32_host_ms_per_step=[
                r["windows"]["mixed_w32"]["host_ms_per_step"] for r in reps])
    print("engine_ab " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
