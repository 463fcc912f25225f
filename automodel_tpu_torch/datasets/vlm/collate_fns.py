"""VLM collators: conversation samples -> numpy batches (counterpart:
``automodel_tpu/datasets/vlm/collate_fns.py``: its default, Qwen2.5-VL
and Phi-4-multimodal paths).

The batch the train step consumes:

* ``input_ids [B, S]`` int32, each image expanded to its placeholder
  tokens by the processor;
* ``pixel_values [B, I, H, W, C]`` float32: each row's image slots (NHWC;
  processors emit flat NCHW, converted and re-rowed here), trailing slots
  zero and never gathered;
* ``labels [B, S]`` int32: ``input_ids`` shifted by one, -100 on the last
  position, on pad / image / special tokens and on every target before
  the start-of-response marker;
* ``loss_mask`` (token-aligned, for the reference schema; dropped before
  the step).

``pad_seq_len_divisible`` right-pads the text fields to a multiple;
``fixed_length`` pads or truncates every batch to one length;
``max_images_per_example`` fixes the slot count.

:func:`qwen2_5_collate_fn` passes Qwen's processor output through as it
is: flat patch rows ``pixel_values [n_patches, C * tps * ps * ps]`` with
``image_grid_thw [n_images, 3]`` (videos: ``pixel_values_videos`` and
``video_grid_thw``), and adds the M-RoPE ``position_ids [B, S, 3]``
computed here (``datasets/vlm/qwen_rope.py``).  :func:`phi4_mm_collate_fn`
passes the audio processor's ``input_audio_embeds`` /
``audio_embed_sizes`` / ``audio_attention_mask`` through.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from automodel_tpu_torch.datasets.utils import CROSS_ENTROPY_IGNORE_IDX
from automodel_tpu_torch.datasets.vlm.utils import extract_skipped_token_ids

logger = logging.getLogger(__name__)


def _as_numpy(x: Any) -> np.ndarray:
    if hasattr(x, "detach"):          # a torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def to_nhwc(pixel_values) -> np.ndarray:
    """``[B, C, H, W]`` -> ``[B, H, W, C]``; NHWC passes through."""
    pv = _as_numpy(pixel_values).astype(np.float32)
    if pv.ndim == 4 and pv.shape[1] in (1, 3) and pv.shape[-1] not in (1, 3):
        pv = np.transpose(pv, (0, 2, 3, 1))
    return pv


def find_response_start(input_ids: Sequence[int],
                        marker_ids: Sequence[int]) -> int:
    """The index after the first occurrence of ``marker_ids`` (0 when the
    marker is absent)."""
    n, m = len(input_ids), len(marker_ids)
    if m == 0:
        return 0
    for i in range(n - m + 1):
        if list(input_ids[i:i + m]) == list(marker_ids):
            return i + m
    return 0


def create_loss_mask_with_start_of_response_token(
        input_ids, processor, start_of_response_token=None) -> List[int]:
    """1 = the token is supervised, 0 = masked (the prompt up to and
    including the marker, and padding)."""
    tokenizer = getattr(processor, "tokenizer", processor)
    ids = [int(t) for t in _as_numpy(input_ids).reshape(-1)]
    start = 0
    if isinstance(start_of_response_token, str):
        marker = tokenizer(start_of_response_token,
                           add_special_tokens=False)["input_ids"]
        start = find_response_start(ids, marker)
    pad_id = getattr(tokenizer, "pad_token_id", None)
    return [0 if (i < start or (pad_id is not None and t == pad_id)) else 1
            for i, t in enumerate(ids)]


def _shifted_masked_labels(input_ids: np.ndarray, skipped_ids: Sequence[int],
                           loss_masks: List[List[int]]) -> np.ndarray:
    """Next-token labels with skipped tokens and unsupervised targets
    masked (the token-aligned mask shifted with the labels)."""
    labels = np.full_like(input_ids, CROSS_ENTROPY_IGNORE_IDX)
    labels[:, :-1] = input_ids[:, 1:]
    if len(skipped_ids):
        labels[np.isin(labels, np.asarray(skipped_ids))] = (
            CROSS_ENTROPY_IGNORE_IDX)
    target_masked = np.asarray(loss_masks)[:, 1:] == 0
    labels[:, :-1][target_masked] = CROSS_ENTROPY_IGNORE_IDX
    return labels


def _gather_media(examples: List[dict], list_key: str,
                  item_key: str) -> Optional[List[Any]]:
    """Each example's media, from its ``list_key`` list or from
    ``item_key`` entries of its conversation's content (None when no
    example has any)."""
    out: List[Any] = []
    found = False
    for ex in examples:
        items = list(ex.get(list_key) or [])
        if not items:
            for turn in ex.get("conversation", []):
                content = turn.get("content")
                if isinstance(content, list):
                    items.extend(c[item_key] for c in content
                                 if isinstance(c, dict) and item_key in c)
        found = found or bool(items)
        out.append(items)
    return out if found else None


def _gather_images(examples: List[dict]) -> Optional[List[Any]]:
    return _gather_media(examples, "images", "image")


def _gather_videos(examples: List[dict]) -> Optional[List[Any]]:
    return _gather_media(examples, "videos", "video")


def _row_image_slots(flat: np.ndarray, counts: List[int],
                     max_images_per_example: Optional[int] = None
                     ) -> np.ndarray:
    """Flat ``[sum(counts), H, W, C]`` (the processor's order) -> per-row
    slots ``[B, I, H, W, C]``, trailing slots zero."""
    if sum(counts) != flat.shape[0]:
        raise ValueError(
            f"processor emitted {flat.shape[0]} images but examples carry "
            f"{sum(counts)}: image order cannot be trusted for per-row "
            "slotting")
    i_max = max(max(counts), 1)
    if max_images_per_example is not None:
        if max(counts) > max_images_per_example:
            raise ValueError(
                f"an example carries {max(counts)} images > "
                f"max_images_per_example={max_images_per_example}")
        i_max = max_images_per_example
    out = np.zeros((len(counts), i_max) + flat.shape[1:], flat.dtype)
    pos = 0
    for r, c in enumerate(counts):
        out[r, :c] = flat[pos:pos + c]
        pos += c
    return out


def _pad_text_fields(out: Dict[str, np.ndarray], processor,
                     divisible: int) -> None:
    pad = (-out["input_ids"].shape[1]) % divisible
    if not pad:
        return
    tokenizer = getattr(processor, "tokenizer", processor)
    pad_id = getattr(tokenizer, "pad_token_id", None) or 0
    out["input_ids"] = np.pad(out["input_ids"], ((0, 0), (0, pad)),
                              constant_values=pad_id)
    out["labels"] = np.pad(out["labels"], ((0, 0), (0, pad)),
                           constant_values=CROSS_ENTROPY_IGNORE_IDX)
    out["loss_mask"] = np.pad(out["loss_mask"], ((0, 0), (0, pad)))


def default_collate_fn(examples: List[dict], processor,
                       start_of_response_token: Optional[str] = None,
                       pad_seq_len_divisible: Optional[int] = None,
                       max_images_per_example: Optional[int] = None,
                       fixed_length: Optional[int] = None
                       ) -> Dict[str, np.ndarray]:
    """Chat template, processor call, per-row image slots, shifted and
    masked labels (the Gemma-3 default path)."""
    texts = [processor.apply_chat_template(ex["conversation"], tokenize=False)
             for ex in examples]
    kwargs: Dict[str, Any] = dict(padding=True, return_tensors="np")
    if fixed_length is not None:
        kwargs.update(padding="max_length", truncation=True,
                      max_length=int(fixed_length))
    images = _gather_images(examples)
    if images is not None:
        kwargs["images"] = images
    batch = processor(text=texts, **kwargs)
    out: Dict[str, np.ndarray] = {
        "input_ids": _as_numpy(batch["input_ids"]).astype(np.int32)}
    if batch.get("pixel_values") is not None:
        counts = [len(imgs) for imgs in (images or [])]
        out["pixel_values"] = _row_image_slots(
            to_nhwc(batch["pixel_values"]), counts, max_images_per_example)
    loss_masks = [create_loss_mask_with_start_of_response_token(
        row, processor, start_of_response_token) for row in out["input_ids"]]
    out["labels"] = _shifted_masked_labels(
        out["input_ids"], extract_skipped_token_ids(processor), loss_masks)
    out["loss_mask"] = np.asarray(loss_masks, np.float32)
    if pad_seq_len_divisible:
        _pad_text_fields(out, processor, int(pad_seq_len_divisible))
    return out


def _qwen_special(processor) -> Dict[str, int]:
    """The special-token ids and the merge size of a Qwen processor (real
    or mock)."""
    tokenizer = getattr(processor, "tokenizer", processor)
    convert = getattr(tokenizer, "convert_tokens_to_ids", None)
    ids = {}
    for name, tok, default in (
            ("image_token_id", "<|image_pad|>", 151655),
            ("video_token_id", "<|video_pad|>", 151656),
            ("vision_start_token_id", "<|vision_start|>", 151652)):
        v = convert(tok) if convert is not None else None
        ids[name] = int(v) if v is not None else default
    ids["spatial_merge_size"] = int(getattr(
        getattr(processor, "image_processor", processor), "merge_size", 2))
    return ids


def _resize_square(img: Any, side: int) -> np.ndarray:
    """An image array resized to ``side x side`` by nearest neighbour: the
    knob that puts images of any aspect on one fixed grid (the Qwen
    processor keeps the aspect)."""
    arr = np.asarray(img)
    yi = (np.arange(side) * arr.shape[0] // side).clip(0, arr.shape[0] - 1)
    xi = (np.arange(side) * arr.shape[1] // side).clip(0, arr.shape[1] - 1)
    return arr[yi][:, xi]


def qwen2_5_collate_fn(examples: List[dict], processor,
                       start_of_response_token: str = "<|im_start|>assistant\n",
                       pad_seq_len_divisible: Optional[int] = None,
                       fixed_length: Optional[int] = None,
                       tokens_per_second: int = 2,
                       resize_images_to: Optional[int] = None
                       ) -> Dict[str, np.ndarray]:
    """Qwen2.5-VL: the ``<|im_start|>assistant`` response marker, the
    processor's flat patch rows and grids passed through, the M-RoPE
    position ids computed here (pads: 1).  ``resize_images_to`` squares
    every image first; a vision span the processor truncated raises
    ``ValueError``."""
    from automodel_tpu_torch.datasets.vlm.qwen_rope import (
        qwen_mrope_position_ids,
    )

    texts = [processor.apply_chat_template(ex["conversation"], tokenize=False)
             for ex in examples]
    kwargs: Dict[str, Any] = dict(padding=True, return_tensors="np")
    if fixed_length is not None:
        kwargs.update(padding="max_length", truncation=True,
                      max_length=int(fixed_length))
    images = _gather_images(examples)
    if images is not None:
        if resize_images_to:
            images = [[_resize_square(i, int(resize_images_to))
                       for i in imgs] for imgs in images]
        kwargs["images"] = images
    videos = _gather_videos(examples)
    if videos is not None:
        kwargs["videos"] = videos
    batch = processor(text=texts, **kwargs)

    input_ids = _as_numpy(batch["input_ids"]).astype(np.int32)
    attn = (None if batch.get("attention_mask") is None
            else _as_numpy(batch["attention_mask"]).astype(np.int32))
    out: Dict[str, np.ndarray] = {"input_ids": input_ids}
    grid = vgrid = spg = None
    if batch.get("pixel_values") is not None:
        out["pixel_values"] = _as_numpy(batch["pixel_values"]).astype(
            np.float32)
        grid = _as_numpy(batch["image_grid_thw"]).astype(np.int32)
        out["image_grid_thw"] = grid
    if batch.get("pixel_values_videos") is not None:
        out["pixel_values_videos"] = _as_numpy(
            batch["pixel_values_videos"]).astype(np.float32)
        vgrid = _as_numpy(batch["video_grid_thw"]).astype(np.int32)
        out["video_grid_thw"] = vgrid
        if batch.get("second_per_grid_ts") is not None:
            # read by the position ids' walk only, never by the model
            spg = np.asarray(_as_numpy(batch["second_per_grid_ts"]),
                             np.float64)

    loss_masks = [create_loss_mask_with_start_of_response_token(
        row, processor, start_of_response_token) for row in input_ids]
    out["labels"] = _shifted_masked_labels(
        input_ids, extract_skipped_token_ids(processor), loss_masks)
    out["loss_mask"] = np.asarray(loss_masks, np.float32)
    sp = _qwen_special(processor)
    for g, tok_key, name in ((grid, "image_token_id", "image"),
                             (vgrid, "video_token_id", "video")):
        if g is None:
            continue
        # a truncated vision span would break the position walk and
        # misplace the features: fail with the cause
        m = sp["spatial_merge_size"]
        expect = int(sum(int(t) * (int(h) // m) * (int(w) // m)
                         for t, h, w in g))
        got = int((input_ids == sp[tok_key]).sum())
        if got != expect:
            raise ValueError(
                f"batch carries {got} {name} placeholder tokens but "
                f"{name}_grid_thw implies {expect}: a {name} span was "
                "truncated (raise fixed_length / max_length) or the "
                "processor's placeholder expansion disagrees with the grid")
    out["position_ids"] = qwen_mrope_position_ids(
        input_ids, grid, attn, video_grid_thw=vgrid,
        second_per_grid_ts=spg, tokens_per_second=tokens_per_second, **sp)
    if pad_seq_len_divisible:
        pad = (-input_ids.shape[1]) % int(pad_seq_len_divisible)
        _pad_text_fields(out, processor, int(pad_seq_len_divisible))
        if pad:
            out["position_ids"] = np.pad(
                out["position_ids"], ((0, 0), (0, pad), (0, 0)),
                constant_values=1)       # HF pads M-RoPE positions with 1
    return out


def phi4_mm_collate_fn(examples: List[dict], processor,
                       max_length: int = 1024,
                       pad_seq_len_divisible: Optional[int] = None
                       ) -> Dict[str, np.ndarray]:
    """Phi-4-multimodal's audio path: ``[user, assistant]`` conversations
    with ``audio`` (``{"array", "sampling_rate"}``); the supervised span is
    the assistant turn's own token ids found in ``input_ids`` (no response
    marker), with a warning and no supervised tokens when they are not
    found.  The processor's audio keys pass through (``input_audio_embeds
    [N, T, F]``, ``audio_embed_sizes [N]``, ``audio_attention_mask [N,
    T]``).  The assistant content is tokenized as a string, as in JAX: a
    list of content parts raises there and here."""
    conversations = [ex["conversation"] for ex in examples]
    for conv in conversations:
        if len(conv) < 2 or conv[1].get("role") != "assistant":
            raise ValueError(
                "phi4_mm_collate_fn expects [user, assistant] conversations; "
                f"got {len(conv)} turns, turn-1 role "
                f"{conv[1].get('role') if len(conv) > 1 else None!r}")
    texts = [processor.apply_chat_template(c, tokenize=False)
             for c in conversations]
    audios = []
    for ex in examples:
        a = ex.get("audio")
        audios.append((a["array"], a["sampling_rate"])
                      if isinstance(a, dict) else a)
    batch = processor(text=texts, audios=audios, padding=True,
                      truncation=True, max_length=max_length,
                      return_tensors="np")
    input_ids = _as_numpy(batch["input_ids"]).astype(np.int32)
    tokenizer = getattr(processor, "tokenizer", processor)
    loss_masks: List[List[int]] = []
    for row, conv in zip(input_ids, conversations):
        ids = [int(t) for t in row]
        answer = tokenizer(conv[1]["content"],
                           add_special_tokens=False)["input_ids"]
        mask = [0] * len(ids)
        start = find_response_start(ids, answer)
        if start:       # the matched answer span itself
            mask[start - len(answer):start] = [1] * len(answer)
        else:
            logger.warning(
                "phi4_mm_collate_fn: assistant answer not found in input_ids "
                "(truncated at max_length=%d, or context-dependent "
                "tokenization); example contributes no supervised tokens",
                max_length)
        loss_masks.append(mask)
    out: Dict[str, np.ndarray] = {"input_ids": input_ids}
    for key in ("input_audio_embeds", "audio_embed_sizes",
                "audio_attention_mask"):
        if batch.get(key) is not None:
            out[key] = _as_numpy(batch[key])
    out["labels"] = _shifted_masked_labels(
        input_ids, extract_skipped_token_ids(processor), loss_masks)
    out["loss_mask"] = np.asarray(loss_masks, np.float32)
    if pad_seq_len_divisible:
        _pad_text_fields(out, processor, int(pad_seq_len_divisible))
    return out


# processor class name -> collate fn
COLLATE_FNS = {"Qwen2_5_VLProcessor": qwen2_5_collate_fn,
               "Phi4MMProcessor": phi4_mm_collate_fn,
               "default": default_collate_fn}
