"""The VLM (image-text-to-text) fine-tuning recipe (counterpart:
``automodel_tpu/recipes/vlm/finetune.py``).

The LLM recipe (``recipes/llm/train_ft.py``) with two hooks swapped, as in
JAX: the data path builds a processor (``processor._target_``, else
``transformers``' ``AutoProcessor`` from the model's checkpoint
directory where the package is installed) and a VLM collator
(``dataloader.collate_fn``, else ``COLLATE_FNS`` by the processor's class
name), padding rows to a multiple of 128 and prefetching two batches
unless the YAML says otherwise; and the freeze mask defaults to frozen
embeddings when the YAML has no ``freeze_config``.  ``max_grad_norm``
defaults to 1.0.  Batches carry ``pixel_values [B, I, H, W, C]`` (or
Qwen2.5-VL's flat patch rows and grids), which the train step hands to the
model; on the host, before a batch goes to the device, its
``image_grid_thw`` / ``video_grid_thw`` rows must equal the model's grids.

    python -m automodel_tpu_torch.recipes.vlm.finetune \\
        -c examples/vlm_finetune/tiny_vlm_mock.yaml --device cpu
"""

from __future__ import annotations

import functools
import logging
from typing import Any, Callable, Dict, Optional

import numpy as np

from automodel_tpu_torch.config.loader import (
    ConfigNode,
    parse_args_and_load_config,
    resolve_target,
)
from automodel_tpu_torch.datasets.dataloader import StatefulDataLoader
from automodel_tpu_torch.datasets.prefetch import wrap_prefetch
from automodel_tpu_torch.datasets.vlm.collate_fns import COLLATE_FNS
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
    accepts_kwarg,
    build_dataset,
)
from automodel_tpu_torch.utils.model_utils import apply_parameter_freezing

logger = logging.getLogger(__name__)


def build_processor(cfg: ConfigNode, model) -> Any:
    """``processor._target_`` instantiated, else ``AutoProcessor`` from the
    model's checkpoint directory; neither raises ``ValueError``."""
    proc_cfg = cfg.get("processor")
    if isinstance(proc_cfg, ConfigNode) and "_target_" in proc_cfg.to_dict():
        return proc_cfg.instantiate()
    kwargs = proc_cfg.to_dict() if isinstance(proc_cfg, ConfigNode) else {}
    ckpt_dir = getattr(model, "checkpoint_dir", None)
    if ckpt_dir is not None:
        try:
            from transformers import AutoProcessor

            return AutoProcessor.from_pretrained(ckpt_dir, **kwargs)
        except Exception as e:
            logger.warning("AutoProcessor unavailable for %s (%s)",
                           ckpt_dir, e)
    raise ValueError(
        "VLM fine-tuning needs a processor: set `processor._target_` in the "
        "config (e.g. automodel_tpu.datasets.vlm.mock.MockVLMProcessor for "
        "offline runs) or point `model` at a checkpoint with processor files")


def select_collate_fn(dl_cfg: Optional[ConfigNode], processor,
                      model=None) -> Callable:
    """An explicit ``dataloader.collate_fn`` node (or callable) wins, bound
    to the processor and handed only the loader's keyword arguments it
    takes; else ``COLLATE_FNS`` by the processor's class name (``default``
    when it has none), with ``max_images_per_example`` / ``fixed_length``
    from the loader's section.  A collator knob that must agree with the
    model -- Qwen's ``tokens_per_second``, which scales the temporal
    position axis -- defaults to ``model``'s value, unless the node sets
    it."""
    node = dl_cfg.get("collate_fn") if isinstance(dl_cfg, ConfigNode) else None
    model_tps = getattr(getattr(getattr(model, "config", None),
                                "vision_config", None),
                        "tokens_per_second", None)

    def bind(fn, call):
        def collate(examples, **kw):
            return call(examples, {k: v for k, v in kw.items()
                                   if accepts_kwarg(fn, k)})
        return collate

    if isinstance(node, ConfigNode) and "_target_" in node.to_dict():
        target = resolve_target(node.get("_target_"))

        def call(examples, kw):
            if (model_tps is not None
                    and "tokens_per_second" not in node.to_dict()
                    and accepts_kwarg(target, "tokens_per_second")):
                kw.setdefault("tokens_per_second", int(model_tps))
            return node.instantiate(examples=examples, processor=processor,
                                    **kw)

        return bind(target, call)
    if callable(node):
        return bind(node, lambda examples, kw: node(
            examples, processor=processor, **kw))
    name = type(processor).__name__
    if name not in COLLATE_FNS:
        logger.warning("No dedicated collate_fn for %s; using default", name)
        name = "default"
    fn = COLLATE_FNS[name]
    extra: Dict[str, Any] = {}
    for knob in ("max_images_per_example", "fixed_length"):
        v = dl_cfg.get(knob) if isinstance(dl_cfg, ConfigNode) else None
        if v is not None and accepts_kwarg(fn, knob):
            extra[knob] = int(v)
    if model_tps is not None and accepts_kwarg(fn, "tokens_per_second"):
        extra["tokens_per_second"] = int(model_tps)
    return functools.partial(fn, processor=processor, **extra)


def build_vlm_dataloader(cfg: ConfigNode, dataset, processor, cfg_key: str,
                         batch_size: int, seed: int, model=None):
    """The loader of ``cfg[cfg_key]`` (its ``_target_``, else
    :class:`StatefulDataLoader`) over ``dataset`` with the VLM collator,
    handed the section's keys it takes, wrapped in the async input pipeline
    at ``prefetch_depth``."""
    dl_cfg = cfg.get(cfg_key)
    kwargs: Dict[str, Any] = {}
    if isinstance(dl_cfg, ConfigNode):
        kwargs = {k: v for k, v in dl_cfg.to_dict().items()
                  if k not in ("_target_", "collate_fn")}
    kwargs.setdefault("batch_size", batch_size)
    kwargs.setdefault("seed", seed)
    depth = int(kwargs.pop("prefetch_depth", 0) or 0)
    target = dl_cfg.get("_target_") if isinstance(dl_cfg, ConfigNode) else None
    cls = resolve_target(target) if target else StatefulDataLoader
    # the collator's knobs (fixed_length, max_images_per_example) are not
    # the loader's
    kwargs = {k: v for k, v in kwargs.items()
              if accepts_kwarg(cls.__init__, k)}
    loader = cls(dataset,
                 collate_fn=select_collate_fn(dl_cfg, processor, model=model),
                 **kwargs)
    return wrap_prefetch(loader, depth)


class FinetuneRecipeForVLM(TrainFinetuneRecipeForNextTokenPrediction):
    """``setup()`` then ``run_train_validation_loop()``."""

    _default_max_grad_norm = 1.0
    _sections = frozenset({"processor"})

    def _check_host_batches(self, batches) -> None:
        """Each microbatch's ``image_grid_thw`` / ``video_grid_thw`` rows
        (zero rows are stacking pads) against the model's ``image_grid``
        / ``video_grid``: a batch made for another grid would fail an
        opaque reshape or, when the patch count happens to divide, train
        on the wrong rotary tables and windows."""
        for key, fixed in (("image_grid_thw",
                            getattr(self.model, "image_grid", None)),
                           ("video_grid_thw",
                            getattr(self.model, "video_grid", None))):
            if fixed is None:
                continue
            for mb in batches:
                g = mb.get(key)
                if g is None:
                    continue
                rows = np.asarray(g)
                real = rows[np.any(rows != 0, axis=-1)]
                if real.size and not np.all(real == np.asarray(fixed)):
                    raise ValueError(
                        f"{key} rows {real.tolist()} do not match the "
                        f"model's static grid {tuple(fixed)}: the tower runs "
                        "one grid; group batches by grid at the collator or "
                        f"set the model's {key.replace('_thw', '')} to "
                        "match")

    def _build_freeze_mask(self):
        """``freeze_config``, defaulting to frozen embeddings."""
        freeze_cfg = self.cfg.get("freeze_config")
        if freeze_cfg is None:
            freeze_cfg = {"freeze_embeddings": True}
        return apply_parameter_freezing(self.model, freeze_cfg)

    def _setup_data(self, batch_size: int) -> None:
        cfg = self.cfg
        self.processor = build_processor(cfg, self.model)
        self.tokenizer = getattr(self.processor, "tokenizer", None)
        dataset = build_dataset(cfg.get("dataset"))
        # rows padded to multiples of 128 and two batches prefetched,
        # unless the YAML says otherwise (the JAX recipe's defaults)
        for key in ("dataloader", "validation_dataloader"):
            if cfg.get(f"{key}.pad_seq_len_divisible") is None:
                cfg.set_by_dotted(f"{key}.pad_seq_len_divisible", 128)
        if cfg.get("dataloader.prefetch_depth") is None:
            cfg.set_by_dotted("dataloader.prefetch_depth", 2)
        self.dataloader = build_vlm_dataloader(
            cfg, dataset, self.processor, "dataloader", batch_size,
            self.rng.seed, model=self.model)
        self.val_dataloader = None
        if cfg.get("validation_dataset") is not None:
            self.val_dataloader = build_vlm_dataloader(
                cfg, build_dataset(cfg.get("validation_dataset")),
                self.processor, "validation_dataloader", batch_size,
                self.rng.seed, model=self.model)


def main(config_path: Optional[str] = None, argv=None):
    """CLI entry: ``-c <yaml>`` plus dotted overrides (``--device cpu``)."""
    logging.basicConfig(level=logging.INFO)
    cfg = parse_args_and_load_config(argv, default_config=config_path)
    recipe = FinetuneRecipeForVLM(cfg)
    recipe.setup()
    recipe.run_train_validation_loop()
    return recipe


if __name__ == "__main__":
    main()
