"""Load a fine-tuned VLM checkpoint and generate from an image and a prompt
(counterpart: ``examples/vlm_generate/generate.py``, with the same
arguments).

A consolidated HF export (a directory with ``config.json``, e.g. a
checkpoint's ``epoch_X_step_Y/model/``) is read through
``AutoModelForImageTextToText.from_pretrained``; an Orbax
(non-consolidated) training checkpoint with ``--base-model`` raises
``NotImplementedError`` (ROADMAP Queue 1 item 7).  The processor is
``transformers``' ``AutoProcessor`` from the checkpoint (or the base
model) directory, as in JAX; the image goes to the processor raw.
Decoding is ``generation/generate.py::generate`` over the dense cache,
the prefill on kernel 9 on the card; the output is cut at the first eos.

    python -m automodel_tpu_torch.examples.vlm_generate \\
        --checkpoint-path ckpts/epoch_0_step_200/model \\
        --prompt "Describe this receipt." --image receipt.png [--device cpu]

``--device`` defaults to ``cuda`` (raises without a card).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")))


def load_model(args):
    """The model of a consolidated export; an Orbax checkpoint needs
    ``--base-model`` and then raises (not ported)."""
    from automodel_tpu_torch.models.auto_model import (
        AutoModelForImageTextToText,
    )
    from automodel_tpu_torch.recipes.llm.train_ft import _later

    path = args.checkpoint_path
    if os.path.exists(os.path.join(path, "config.json")):
        return AutoModelForImageTextToText.from_pretrained(
            path, load_weights=True, device=args.device)
    if args.base_model is None:
        raise SystemExit("--base-model is required for orbax checkpoints")
    raise _later("checkpoint_format")


def load_image(path_or_url: str):
    """The raw PIL image: the processor rescales and normalises it, as the
    training collators hand it raw images."""
    from PIL import Image

    if path_or_url.startswith(("http://", "https://")):
        raise SystemExit("zero-egress environment: pass a local image path")
    return Image.open(path_or_url).convert("RGB")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint-path", required=True)
    p.add_argument("--base-model", default=None,
                   help="HF model dir (orbax checkpoints only)")
    p.add_argument("--prompt", required=True)
    p.add_argument("--image", required=True, help="local image path")
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from transformers import AutoProcessor

    from automodel_tpu_torch.datasets.vlm.collate_fns import to_nhwc
    from automodel_tpu_torch.generation import GenerationConfig, generate

    model = load_model(args)
    proc_dir = (args.checkpoint_path
                if os.path.exists(os.path.join(args.checkpoint_path,
                                               "tokenizer_config.json"))
                else args.base_model)
    processor = AutoProcessor.from_pretrained(proc_dir)
    conversation = [{"role": "user", "content": [
        {"type": "image", "image": args.image},
        {"type": "text", "text": args.prompt}]}]
    text = processor.apply_chat_template(conversation, tokenize=False,
                                         add_generation_prompt=True)
    batch = processor(text=[text], images=[[load_image(args.image)]],
                      return_tensors="np")
    tok = processor.tokenizer
    cfg = GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        do_sample=args.temperature > 0,
        temperature=max(args.temperature, 1e-6),
        eos_token_id=getattr(tok, "eos_token_id", None),
        pad_token_id=getattr(tok, "pad_token_id", 0) or 0)
    out = generate(model, np.asarray(batch["input_ids"], np.int32),
                   config=cfg, pixel_values=to_nhwc(batch["pixel_values"]))
    # cut at eos, not by the pad value (a pad id of 0 can be a real token)
    row = [int(t) for t in out[0]]
    if cfg.eos_token_id is not None and cfg.eos_token_id in row:
        row = row[: row.index(cfg.eos_token_id)]
    print(tok.decode(row, skip_special_tokens=True))


if __name__ == "__main__":
    main()
