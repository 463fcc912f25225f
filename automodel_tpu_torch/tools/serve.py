"""Serve synthetic requests through the port's decode engine and print one
JSON report (counterpart: ``tools/serve.py``).

    python -m automodel_tpu_torch.tools.serve \\
        -c automodel_tpu_torch/examples/llama3_2_1b_serve.yaml
    python -m automodel_tpu_torch.tools.serve -c ... --kv-dtype int8
    python -m automodel_tpu_torch.tools.serve -c ... --prefix-cache on
    python -m automodel_tpu_torch.tools.serve -c ... --speculative ngram
    python -m automodel_tpu_torch.tools.serve -c ... --adapters 4 --tenant 2
    python -m automodel_tpu_torch.tools.serve -c ... --deadline-s 30 \\
        --max-waiting 8 --shed-policy by_deadline --watchdog-s 10
    python -m automodel_tpu_torch.tools.serve -c ... \\
        --fault serve_watchdog_stall:3
    python -m automodel_tpu_torch.tools.serve -c ... --eval --limit 16
    python -m automodel_tpu_torch.tools.serve -c ... --replicas 2 \\
        --router-policy least_loaded --drill-loss-at 5
    python -m automodel_tpu_torch.tools.serve -c ... --device cpu

The YAML names the model (``_target_`` + config; weights are drawn from
``--seed``), the ``serving:`` knobs and the ``generation:`` section; the
JAX package's serving YAMLs load unchanged.  The flags override the
``serving:`` keys as in the JAX tool.  ``--adapters N`` loads N synthetic
rank-r adapters into slots 1..N and round-robins the requests over
adapter ids 0..N; ``--fault`` arms a fault spec for a drill; ``--eval``
scores the config's ``validation_dataset`` (local data) through the
engine instead.  SIGTERM / SIGINT drain the engine (stop admitting,
finish in-flight work within ``--drain-grace-s``); a second ^C aborts.

The elastic fleet (``serving/fleet.py``): ``--replicas N`` drives the
same requests through a ``FleetRouter`` over N engines (``--router-policy``
picks the routing), and ``--drill-loss-at K`` arms
``fleet_replica_loss`` on the K-th health poll.  The drive polls the
fleet's health before every step and marks a lost replica returning, so
it passes probation and is admitted again, warmed from a live peer's
weights; after the traffic it keeps polling (idle) until the admission
lands or ``4 x fleet_probation_polls`` polls have passed.

The report carries ``decode_tok_s``, ``wall_s``, ``drained``,
``not_finished``, the ``serve_*`` timers and the engine's stats (the
fleet's with ``replica_losses``, ``replays``, ``readmissions`` and
``fleet_rejected``).  The exit code is 0 only when every request FINISHED
(an aborted, expired, rejected or unfinished one exits 1).  The default
device is ``cuda``; without a card the command fails unless ``--device
cpu``.  :func:`serve` is the same run for a caller that wants the engine
(or fleet) and the prompts back, and may pass a built model.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time

import numpy as np


def _drive(engine, prompts, *, deadline_s, max_queue_s, drain_grace_s,
           handler, adapter_ids=None) -> dict:
    """Submit every prompt and step to completion, draining on a trapped
    signal; returns ``{"wall_s", "drained"}``.  The stall bound of
    ``engine.run()`` holds here too."""
    from automodel_tpu_torch.serving.kv_cache import blocks_needed

    t0 = time.perf_counter()
    drained = False
    ids = adapter_ids or [0] * len(prompts)
    for p, aid in zip(prompts, ids):
        engine.submit(p, deadline_s=deadline_s, max_queue_s=max_queue_s,
                      adapter_id=aid)
    max_steps = 64 + 8 * sum(
        blocks_needed(len(r.prompt), engine.config.prefill_chunk)
        + r.max_new_tokens + 1
        for r in engine.requests.values() if not r.finished)
    steps = 0
    while engine.scheduler.has_work():
        if handler is not None and handler.received:
            engine.drain(drain_grace_s)
            drained = True
            break
        engine.step()
        steps += 1
        if steps > max_steps:
            raise RuntimeError(
                f"engine made no progress within {max_steps} steps -- "
                "scheduler stall")
    return {"wall_s": time.perf_counter() - t0, "drained": drained}


def _drive_fleet(fleet, prompts, *, deadline_s, max_queue_s, drain_grace_s,
                 handler, adapter_ids=None) -> dict:
    """:func:`_drive` for a fleet, with one health poll before every step
    and automatic grow-back (a lost replica is marked returning, so the
    polls walk it through probation and admission); after the traffic, idle
    polls until every replica is back or ``4 x probation_polls`` polls have
    passed."""
    from automodel_tpu_torch.serving.kv_cache import blocks_needed

    t0 = time.perf_counter()
    drained = False
    ids = adapter_ids or [0] * len(prompts)
    for p, aid in zip(prompts, ids):
        fleet.submit(p, deadline_s=deadline_s, max_queue_s=max_queue_s,
                     adapter_id=aid)
    max_steps = 64 + 8 * sum(
        blocks_needed(len(r.prompt), fleet.config.prefill_chunk)
        + r.max_new_tokens + 1
        for r in fleet.requests.values() if not r.finished)
    steps = 0
    while fleet.has_work():
        if handler is not None and handler.received:
            fleet.drain(drain_grace_s)
            drained = True
            break
        fleet.poll_health(step=steps)
        for rep in fleet.replicas:
            if not rep.alive:
                fleet.note_return(rep.replica_id)
        fleet.step()
        steps += 1
        if steps > max_steps:
            raise RuntimeError(
                f"fleet made no progress within {max_steps} steps -- "
                "scheduler stall")
    for extra in range(steps, steps + 4 * fleet.probation_polls):
        if all(r.alive for r in fleet.replicas):
            break
        fleet.poll_health(step=extra)
    return {"wall_s": time.perf_counter() - t0, "drained": drained}


def synthetic_adapters(model, rank: int, rng, scale: float = 0.01) -> dict:
    """One synthetic rank-``rank`` adapter tree in the JAX layout (A and B
    normal with standard deviation ``scale``, fp32) for every ``*_proj``
    of ``model``."""
    from automodel_tpu_torch.peft.lora import PeftConfig, adapter_slab_shapes

    shapes = adapter_slab_shapes(model, PeftConfig(dim=rank), 1)
    return {path: {"A": (scale * rng.standard_normal((a[0],) + a[2:])
                         ).astype(np.float32),
                   "B": (scale * rng.standard_normal((b[0],) + b[2:])
                         ).astype(np.float32)}
            for path, (a, b) in shapes.items()}


def main(argv=None) -> int:
    return serve(argv)["rc"]


def serve(argv=None, model=None) -> dict:
    """Parse ``argv``, serve, print the report; returns ``{"rc", "report",
    "engine", "prompts"}`` (``engine`` is the ``FleetRouter`` in fleet
    mode).  ``model`` replaces the YAML's (already on the device)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", "-c", required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=16,
                    help="synthetic requests to drive (ignored with --eval)")
    ap.add_argument("--max-new", type=int, default=None,
                    help="tokens per request (default: generation section)")
    ap.add_argument("--kv-dtype", default=None,
                    help="override serving.kv_cache_dtype (e.g. int8)")
    ap.add_argument("--policy", default=None,
                    help="override serving.scheduler_policy (fcfs / sjf)")
    ap.add_argument("--prefix-cache", default=None, choices=["on", "off"],
                    dest="prefix_cache",
                    help="override serving.prefix_caching")
    ap.add_argument("--speculative", default=None, choices=["off", "ngram"],
                    help="override serving.speculative")
    ap.add_argument("--spec-k", type=int, default=None, dest="spec_k",
                    help="override serving.spec_k (draft tokens per row)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request end-to-end deadline (default none)")
    ap.add_argument("--max-queue-s", type=float, default=None,
                    help="per-request WAITING-time TTL (default none)")
    ap.add_argument("--watchdog-s", type=float, default=None,
                    help="override serving.watchdog_s")
    ap.add_argument("--max-waiting", type=int, default=None,
                    help="override serving.max_waiting (queue bound)")
    ap.add_argument("--shed-policy", default=None,
                    help="override serving.shed_policy")
    ap.add_argument("--drain-grace-s", type=float, default=None,
                    help="drain window after SIGTERM / SIGINT (default: "
                         "serving.drain_grace_s)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="override serving.replicas (> 1 drives a "
                         "FleetRouter over that many engines)")
    ap.add_argument("--router-policy", default=None,
                    help="override serving.router_policy (round_robin / "
                         "least_loaded / by_deadline)")
    ap.add_argument("--drill-loss-at", type=int, default=None,
                    help="arm fleet_replica_loss on the N-th health poll "
                         "(one poll per step); implies fleet mode")
    ap.add_argument("--adapters", type=int, default=None,
                    help="override serving.max_adapters, load that many "
                         "synthetic adapters into slots 1..N and "
                         "round-robin the requests over ids 0..N")
    ap.add_argument("--tenant", type=int, default=None,
                    help="override serving.tenant_quota")
    ap.add_argument("--fault", default=None,
                    help="arm a fault spec for a drill, e.g. "
                         "'serve_block_alloc:3,serve_watchdog_stall:5'")
    ap.add_argument("--eval", action="store_true",
                    help="score the config's validation_dataset instead")
    ap.add_argument("--limit", type=int, default=16,
                    help="eval rows (with --eval)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from automodel_tpu_torch.config.loader import load_yaml_config
    from automodel_tpu_torch.generation import GenerationConfig
    from automodel_tpu_torch.serving import (
        DecodeEngine,
        FleetRouter,
        build_serving_config,
    )
    from automodel_tpu_torch.training.timers import SERVE_TIMERS, Timers
    from automodel_tpu_torch.utils import fault_injection as fi
    from automodel_tpu_torch.utils.device import resolve_device
    from automodel_tpu_torch.utils.sig_utils import DistributedSignalHandler

    device = resolve_device(args.device)
    cfg = load_yaml_config(args.config)
    for flag, dotted in (("kv_dtype", "serving.kv_cache_dtype"),
                         ("policy", "serving.scheduler_policy"),
                         ("prefix_cache", "serving.prefix_caching"),
                         ("speculative", "serving.speculative"),
                         ("spec_k", "serving.spec_k"),
                         ("watchdog_s", "serving.watchdog_s"),
                         ("max_waiting", "serving.max_waiting"),
                         ("shed_policy", "serving.shed_policy"),
                         ("drain_grace_s", "serving.drain_grace_s"),
                         ("replicas", "serving.replicas"),
                         ("router_policy", "serving.router_policy"),
                         ("adapters", "serving.max_adapters"),
                         ("tenant", "serving.tenant_quota")):
        v = getattr(args, flag)
        if v is not None:
            cfg.set_by_dotted(dotted, v)
    scfg = build_serving_config(cfg)
    if model is None:
        model = cfg.model.instantiate(seed=args.seed, device=device)
    gen_node = cfg.get("generation")
    gen = GenerationConfig(**(gen_node.to_dict() if gen_node else {}))
    if args.max_new is not None:
        gen = GenerationConfig(**{**gen.__dict__,
                                  "max_new_tokens": args.max_new})

    if args.eval:
        from automodel_tpu_torch.serving.eval import eval_config_dataset

        report = eval_config_dataset(cfg, model, via="engine",
                                     limit=args.limit, serving=scfg,
                                     device=device)
        report.pop("tokens")
        print(json.dumps(report))
        return {"rc": 0, "report": report, "engine": None, "prompts": None}

    fleet_mode = (scfg.replicas or 1) > 1 or args.drill_loss_at is not None
    fault_spec = args.fault
    if args.drill_loss_at is not None:
        drill = f"fleet_replica_loss:{args.drill_loss_at}"
        fault_spec = f"{fault_spec},{drill}" if fault_spec else drill
    if fault_spec:
        fi.configure_faults(fault_spec)
    timers = Timers(device=device)
    kind = FleetRouter if fleet_mode else DecodeEngine
    engine = kind(model, scfg, generation=gen, device=device,
                  sample_seed=args.seed, timers=timers)
    vocab = model.config.vocab_size
    rng = np.random.default_rng(args.seed)
    n_adapters = args.adapters or 0
    if n_adapters:
        rank = (engine.replicas[0].engine if fleet_mode
                else engine).adapter_slots.rank
        for slot in range(1, n_adapters + 1):
            engine.load_adapter(slot, synthetic_adapters(model, rank, rng),
                                name=f"tenant-{slot}")
    prompts = [rng.integers(1, vocab, int(n)).tolist()
               for n in rng.integers(
                   4, max(5, scfg.max_model_len - gen.max_new_tokens),
                   args.requests)]
    adapter_ids = [i % (n_adapters + 1) for i in range(len(prompts))]
    # warm-up off the clock (first launches, allocator, kernel build); a
    # fleet: one request per replica
    for _ in range(len(engine.replicas) if fleet_mode else 1):
        engine.submit(prompts[0])
    engine.run()
    # SIGTERM and a first ^C drain; a second ^C aborts a hung drain
    with DistributedSignalHandler([signal.SIGTERM, signal.SIGINT]) as h:
        drive = (_drive_fleet if fleet_mode else _drive)(
            engine, prompts, deadline_s=args.deadline_s,
            max_queue_s=args.max_queue_s,
            drain_grace_s=(args.drain_grace_s
                           if args.drain_grace_s is not None
                           else scfg.drain_grace_s),
            handler=h, adapter_ids=adapter_ids)
    if fault_spec:
        fi.reset_faults()
    stats = engine.stats()
    outcomes = engine.outcome_counts()
    if fleet_mode:
        engine.teardown()        # retract the live-params advertisements
    # the warm-up requests are among engine.requests: they finished first
    not_finished = sum(n for state, n in outcomes.items()
                       if state != "finished")
    dt = drive["wall_s"]
    report = {
        "requests": args.requests,
        "decode_tok_s": args.requests * gen.max_new_tokens / dt,
        "wall_s": dt,
        "drained": drive["drained"],
        "not_finished": not_finished,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "timers_ms": {n: v * 1e3 for n, v in timers.get_elapsed(
            names=list(SERVE_TIMERS), reset=False).items()},
        **stats,
    }
    print(json.dumps(report))
    rc = 0
    if not_finished:
        print(f"serve: {not_finished} request(s) did not finish "
              f"(outcomes: {outcomes}) -- exiting nonzero", file=sys.stderr)
        rc = 1
    return {"rc": rc, "report": report, "engine": engine, "prompts": prompts}


if __name__ == "__main__":
    raise SystemExit(main())
