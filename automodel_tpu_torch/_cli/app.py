"""``automodel-torch <finetune|pretrain> <llm|vlm> -c cfg.yaml [--a.b v ...]``
(counterpart: ``automodel_tpu/_cli/app.py``).

The same verbs and dispatch as the JAX package's CLI: ``finetune llm`` and
``pretrain llm`` run the port's SFT recipe
(``recipes/llm/train_ft.py::main``) with the config and the dotted
overrides (``parse_cli_overrides``; ``--device cpu`` runs on the CPU), and
``finetune vlm`` the VLM recipe (``recipes/vlm/finetune.py::main``).
One process drives one card, so ``--nproc-per-node`` is accepted and
ignored.  A config with a ``slurm:`` or ``k8s:`` section raises (ROADMAP
Queue 1 item 12).

    python -m automodel_tpu_torch._cli.app finetune llm \\
        -c automodel_tpu_torch/examples/tiny_llama_sft.yaml --device cpu
"""

from __future__ import annotations

import argparse
import importlib
import logging
import sys
from typing import List, Optional

logger = logging.getLogger(__name__)

RECIPES = {
    ("finetune", "llm"): "automodel_tpu_torch.recipes.llm.train_ft",
    ("pretrain", "llm"): "automodel_tpu_torch.recipes.llm.train_ft",
    ("finetune", "vlm"): "automodel_tpu_torch.recipes.vlm.finetune",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="automodel-torch",
        description="fine-tuning / pre-training on an NVIDIA card "
                    "(the PyTorch port)")
    parser.add_argument("command", choices=["finetune", "pretrain"])
    parser.add_argument("domain", choices=["llm", "vlm"])
    parser.add_argument("--config", "-c", required=True)
    parser.add_argument("--nproc-per-node", type=int, default=None,
                        help="accepted for the JAX CLI's sake and ignored: "
                             "one process drives one card")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    args, overrides = build_parser().parse_known_args(argv)
    if (args.command, args.domain) not in RECIPES:
        raise SystemExit(f"No recipe for {args.command} {args.domain}")
    from automodel_tpu_torch.config.loader import (
        load_yaml_config,
        parse_cli_overrides,
    )

    cfg = load_yaml_config(args.config)
    for dotted, value in parse_cli_overrides(overrides):
        cfg.set_by_dotted(dotted, value)
    for launcher in ("slurm", "k8s"):
        if cfg.get(launcher) is not None:
            raise NotImplementedError(
                f"the {launcher} launcher is not ported yet: it comes with "
                "ROADMAP Queue 1 item 12 (run the recipe on the machine "
                "that holds the card)")
    if args.nproc_per_node not in (None, 1):
        logger.info("--nproc-per-node %s ignored: one process drives one "
                    "card", args.nproc_per_node)
    recipe_main = importlib.import_module(
        RECIPES[(args.command, args.domain)]).main
    recipe_main(argv=["--config", args.config] + overrides)
    return 0


if __name__ == "__main__":
    sys.exit(main())
