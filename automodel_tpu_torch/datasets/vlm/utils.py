"""VLM dataset utilities (counterpart: ``automodel_tpu/datasets/vlm/
utils.py``): the special tokens kept out of the loss, the Donut-style
``json2token`` serialisation of CORD-v2's ground truth, and
``process_text_batch``."""

from __future__ import annotations

from typing import Any, List

# Special tokens whose label positions are always loss-masked, per model
# family (pad / image / boi / eoi for Gemma-3, vision tokens for
# Qwen2.5-VL, ...)
SKIPPED_TOKENS = [
    "<pad>", "<image>", "<image_soft_token>", "<start_of_image>",
    "<end_of_image>", "<|image_pad|>", "<|vision_start|>", "<|vision_end|>",
    "<|im_start|>", "<|im_end|>", "<boi>", "<eoi>",
]


def extract_skipped_token_ids(processor) -> List[int]:
    """Token ids to mask out of the loss for this processor / tokenizer:
    the vocabulary's ``SKIPPED_TOKENS`` and the pad / image / boi / eoi
    ids the processor or its tokenizer carries."""
    tokenizer = getattr(processor, "tokenizer", processor)
    ids: set = set()
    vocab = {}
    if hasattr(tokenizer, "get_vocab"):
        try:
            vocab = tokenizer.get_vocab()
        except Exception:
            vocab = {}
    for tok in SKIPPED_TOKENS:
        if tok in vocab:
            ids.add(vocab[tok])
    for attr in ("pad_token_id", "image_token_id", "boi_token_id",
                 "eoi_token_id"):
        v = getattr(processor, attr, None) or getattr(tokenizer, attr, None)
        if v is not None:
            ids.add(int(v))
    return sorted(ids)


def json2token(obj: Any, sort_json_key: bool = True) -> str:
    """A JSON object as a token sequence (the Donut / CORD-v2 ground-truth
    format): ``<s_key>value</s_key>`` for each key (reverse-sorted),
    ``<sep/>`` between list items, a lone ``text_sequence`` as it is."""
    if isinstance(obj, dict):
        if len(obj) == 1 and "text_sequence" in obj:
            return obj["text_sequence"]
        output = ""
        keys = sorted(obj.keys(), reverse=True) if sort_json_key else obj.keys()
        for k in keys:
            output += (f"<s_{k}>" + json2token(obj[k], sort_json_key)
                       + f"</s_{k}>")
        return output
    if isinstance(obj, list):
        return "<sep/>".join(json2token(v, sort_json_key) for v in obj)
    return str(obj)


def process_text_batch(processor, texts: List[str], images=None):
    """Tokenize a text batch, with images when given, through an HF-style
    processor."""
    kwargs = dict(text=texts, padding=True, return_tensors="np")
    if images is not None:
        kwargs["images"] = images
    return processor(**kwargs)
