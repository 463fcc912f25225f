"""Serve synthetic requests through the port's decode engine and print one
JSON report (counterpart: ``tools/serve.py``).

    python -m automodel_tpu_torch.tools.serve \\
        -c automodel_tpu_torch/examples/llama3_2_1b_serve.yaml
    python -m automodel_tpu_torch.tools.serve -c ... --kv-dtype int8
    python -m automodel_tpu_torch.tools.serve -c ... --device cpu --requests 4

The YAML names the model (``_target_`` + config; weights are drawn from
``--seed``), the ``serving:`` knobs and the ``generation:`` section; the
JAX package's serving YAMLs load unchanged.  The report carries
``decode_tok_s``, ``wall_s``, ``not_finished`` and the engine stats.  The
exit code is 0 only when every request FINISHED.  The default device is
``cuda``; without a card the command fails unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", "-c", required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--kv-dtype", default=None,
                    help="override serving.kv_cache_dtype (e.g. int8)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.generation import GenerationConfig
    from automodel_tpu_torch.serving import DecodeEngine, build_serving_config
    from automodel_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = load_yaml_config(args.config)
    if args.kv_dtype is not None:
        cfg.set_by_dotted("serving.kv_cache_dtype", args.kv_dtype)
    scfg = build_serving_config(cfg)
    model = cfg.model.instantiate(seed=args.seed, device=device)
    gen_node = cfg.get("generation")
    gen = GenerationConfig(**(gen_node.to_dict() if gen_node else {}))
    engine = DecodeEngine(model, scfg, generation=gen, device=device,
                          sample_seed=args.seed)
    vocab = model.config.vocab_size
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, vocab, int(n)).tolist()
               for n in rng.integers(
                   4, max(5, scfg.max_model_len - gen.max_new_tokens),
                   args.requests)]
    # warm-up off the clock (first launches, allocator, kernel build)
    engine.submit(prompts[0])
    engine.run()
    t0 = time.perf_counter()
    for p in prompts:
        engine.submit(p)
    engine.run()
    dt = time.perf_counter() - t0         # step() ends in a host sync
    stats = engine.stats()
    not_finished = sum(n for state, n in stats["outcomes"].items()
                       if state != "finished")
    report = {
        "requests": args.requests,
        "decode_tok_s": args.requests * gen.max_new_tokens / dt,
        "wall_s": dt,
        "not_finished": not_finished,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        **stats,
    }
    print(json.dumps(report))
    if not_finished:
        print(f"serve: {not_finished} request(s) did not finish "
              f"(outcomes: {stats['outcomes']})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
