"""Mock VLM processor and dataset (counterpart: ``automodel_tpu/datasets/
vlm/mock.py``): offline stand-ins for an HF ``AutoProcessor`` and hub
data.

:class:`MockVLMProcessor` speaks the processor surface the collators use:
``apply_chat_template(conversation, tokenize=False)`` (one ``<image>``
word per vision token), ``__call__(text=, images=, padding=,
return_tensors="np")`` (NCHW ``pixel_values``, as HF image processors
emit), and a ``tokenizer`` with ``get_vocab`` / ``pad_token_id`` /
callable tokenization (a whitespace word hash into the vocabulary).
:class:`Qwen2_5_VLProcessor` is the Qwen processor's stand-in (flat patch
rows and grids), :func:`make_mock_video_dataset` the video conversations
it takes; :class:`Phi4MMProcessor` Phi-4-multimodal's (audio frames and
placeholders), :func:`make_mock_audio_dataset` its audio conversations.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional

import numpy as np

IMAGE_PLACEHOLDER = "<image>"
RESPONSE_MARKER = "<assistant>"


class _MockTokenizer:
    """Whitespace word-hash tokenizer with a stable special-token block."""

    def __init__(self, vocab_size: int, image_token_id: int):
        self.vocab_size = vocab_size
        self.pad_token_id = 0
        self.image_token_id = image_token_id
        self._special = {
            "<pad>": 0, "<bos>": 1, "<eos>": 2,
            RESPONSE_MARKER: 3, "<user>": 4,
            IMAGE_PLACEHOLDER: image_token_id,
        }

    def get_vocab(self) -> Dict[str, int]:
        return dict(self._special)

    def convert_tokens_to_ids(self, token: str) -> Optional[int]:
        return self._special.get(token)

    def _word_id(self, word: str) -> int:
        if word in self._special:
            return self._special[word]
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        n_reserved = 8
        return n_reserved + h % (self.vocab_size - n_reserved)

    def __call__(self, text: str, add_special_tokens: bool = True,
                 **_kw) -> Dict[str, List[int]]:
        return {"input_ids": [self._word_id(w) for w in text.split()]}


class MockVLMProcessor:
    """``processor._target_: automodel_tpu.datasets.vlm.mock.
    MockVLMProcessor``: ``(image_size / patch_size) ** 2`` placeholders an
    image."""

    def __init__(self, vocab_size: int = 512, image_size: int = 32,
                 patch_size: int = 16, num_channels: int = 3,
                 image_token_id: int = 7):
        self.image_size = image_size
        self.patch_size = patch_size
        self.num_channels = num_channels
        self.image_token_id = image_token_id
        self.num_patches = (image_size // patch_size) ** 2
        self.tokenizer = _MockTokenizer(vocab_size, image_token_id)

    def apply_chat_template(self, conversation: List[dict],
                            tokenize: bool = False, **_kw) -> str:
        """Conversation -> one string, each image expanded to one
        ``<image>`` word per vision token."""
        parts: List[str] = []
        for turn in conversation:
            parts.append("<user>" if turn["role"] == "user"
                         else RESPONSE_MARKER)
            content = turn["content"]
            if isinstance(content, str):
                parts.append(content)
                continue
            for c in content:
                if c.get("type") == "image":
                    parts.extend([IMAGE_PLACEHOLDER] * self.num_patches)
                elif c.get("type") == "text":
                    parts.append(c["text"])
        parts.append("<eos>")
        text = " ".join(parts)
        if tokenize:
            return self.tokenizer(text)["input_ids"]
        return text

    def _to_pixels(self, img: Any) -> np.ndarray:
        """An image array -> normalized ``[C, H, W]`` float32 (NCHW),
        resized by nearest neighbour."""
        arr = np.asarray(img, dtype=np.float32)
        if arr.ndim == 2:
            arr = np.stack([arr] * self.num_channels, axis=-1)
        s = self.image_size
        if arr.shape[0] != s or arr.shape[1] != s:
            yi = (np.arange(s) * arr.shape[0] // s).clip(0, arr.shape[0] - 1)
            xi = (np.arange(s) * arr.shape[1] // s).clip(0, arr.shape[1] - 1)
            arr = arr[yi][:, xi]
        return (arr / 127.5 - 1.0).transpose(2, 0, 1)

    def __call__(self, text: List[str],
                 images: Optional[List[List[Any]]] = None,
                 padding: bool = True, return_tensors: str = "np",
                 truncation: bool = False, max_length: Optional[int] = None,
                 **_kw) -> Dict[str, np.ndarray]:
        seqs = [self.tokenizer(t)["input_ids"] for t in text]
        if truncation and max_length:
            seqs = [s[:max_length] for s in seqs]
        width = max(len(s) for s in seqs)
        if padding == "max_length" and max_length:
            width = max_length
        pad = self.tokenizer.pad_token_id
        batch: Dict[str, np.ndarray] = {
            "input_ids": np.asarray(
                [s + [pad] * (width - len(s)) for s in seqs], np.int64),
            "attention_mask": np.asarray(
                [[1] * len(s) + [0] * (width - len(s)) for s in seqs],
                np.int64),
        }
        if images is not None:
            flat = [self._to_pixels(i) for imgs in images for i in imgs]
            if flat:
                batch["pixel_values"] = np.stack(flat, axis=0)
        return batch


def make_mock_vlm_dataset(num_samples: int = 64, image_size: int = 32,
                          seed: int = 0,
                          limit_dataset_samples: Optional[int] = None,
                          desc_words: int = 5, **_kw) -> List[dict]:
    """Synthetic image -> description conversations in the sample format of
    the real dataset makers (``datasets/vlm/datasets.py``); ``desc_words`` sizes
    the answer."""
    rng = np.random.default_rng(seed)
    n = min(num_samples, limit_dataset_samples or num_samples)
    words = ["red", "blue", "green", "cat", "dog", "car", "tree", "house",
             "big", "small", "round", "square"]
    out = []
    for _ in range(n):
        img = rng.integers(0, 256, (image_size, image_size, 3)).astype(
            np.uint8)
        desc = " ".join(rng.choice(words, size=int(desc_words)))
        out.append({
            "conversation": [
                {"role": "user", "content": [
                    {"type": "image"},
                    {"type": "text", "text": "Describe this image."}]},
                {"role": "assistant", "content": [
                    {"type": "text", "text": desc}]},
            ],
            "images": [img],
        })
    return out


class Qwen2_5_VLProcessor:
    """``processor._target_: automodel_tpu.datasets.vlm.mock.
    Qwen2_5_VLProcessor``: the Qwen processor's contract under its real
    class name (``COLLATE_FNS`` dispatches by it).  The chat template
    expands an image to ``<|vision_start|>``, one ``<|image_pad|>`` per
    merged unit and ``<|vision_end|>`` (a video likewise with
    ``<|video_pad|>``); ``__call__`` emits flat patch rows ``[n_patches,
    C * tps * ps * ps]`` in merge-unit grouped order with
    ``image_grid_thw`` (videos: ``pixel_values_videos``,
    ``video_grid_thw`` and ``second_per_grid_ts``).  The special ids are
    5 (vision start), 6 (image pad), 7 (vision end), 8-11 (the chat
    markers) and 12 (video pad)."""

    def __init__(self, vocab_size: int = 256, grid=(1, 4, 4),
                 patch_size: int = 4, temporal_patch_size: int = 2,
                 merge_size: int = 2, num_channels: int = 3,
                 video_grid=(2, 4, 4), second_per_grid_t: float = 1.0):
        self.grid = tuple(grid)
        self.video_grid = tuple(video_grid)
        self.second_per_grid_t = float(second_per_grid_t)
        self.patch_size = patch_size
        self.temporal_patch_size = temporal_patch_size
        self.merge_size = merge_size
        self.num_channels = num_channels
        t, h, w = self.grid
        self.n_units = t * (h // merge_size) * (w // merge_size)
        vt, vh, vw = self.video_grid
        self.n_video_units = vt * (vh // merge_size) * (vw // merge_size)
        self.image_size = (h * patch_size, w * patch_size)
        self.tokenizer = _MockTokenizer(vocab_size, image_token_id=0)
        self.tokenizer._special.update({
            "<|vision_start|>": 5, "<|image_pad|>": 6, "<|vision_end|>": 7,
            "<|im_start|>": 8, "<|im_end|>": 9, "assistant": 10, "user": 11,
            "<|video_pad|>": 12,
        })
        self.image_processor = self           # exposes .merge_size

    def apply_chat_template(self, conversation, tokenize=False, **_kw):
        parts = []
        for turn in conversation:
            parts += ["<|im_start|>",
                      "assistant" if turn["role"] == "assistant" else "user"]
            content = turn["content"]
            if isinstance(content, str):
                parts.append(content)
            else:
                for c in content:
                    if c.get("type") == "image":
                        parts += (["<|vision_start|>"]
                                  + ["<|image_pad|>"] * self.n_units
                                  + ["<|vision_end|>"])
                    elif c.get("type") == "video":
                        parts += (["<|vision_start|>"]
                                  + ["<|video_pad|>"] * self.n_video_units
                                  + ["<|vision_end|>"])
                    elif c.get("type") == "text":
                        parts.append(c["text"])
            parts.append("<|im_end|>")
        text = " ".join(parts)
        return self.tokenizer(text)["input_ids"] if tokenize else text

    def _patchify(self, img, grid=None) -> np.ndarray:
        """An image (or a video's first frame) -> ``[t * h * w, C * tps *
        ps * ps]`` float32 rows, resized by nearest neighbour, each patch
        repeated over the temporal patch and the grid's frames."""
        t, h, w = grid or self.grid
        ps, tps, C = self.patch_size, self.temporal_patch_size, \
            self.num_channels
        if np.asarray(img).ndim == 4:      # a video [frames, H, W, C]
            img = np.asarray(img)[0]
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = np.stack([arr] * C, axis=-1)
        hh, ww = h * ps, w * ps
        yi = (np.arange(hh) * arr.shape[0] // hh).clip(0, arr.shape[0] - 1)
        xi = (np.arange(ww) * arr.shape[1] // ww).clip(0, arr.shape[1] - 1)
        arr = arr[yi][:, xi] / 127.5 - 1.0             # [hh, ww, C]
        m = self.merge_size
        p = arr.reshape(h // m, m, ps, w // m, m, ps, C)
        p = p.transpose(0, 3, 1, 4, 6, 2, 5)           # [gh, gw, m, m, C, ps, ps]
        p = p.reshape(h * w, C, ps, ps)
        p = np.repeat(p[:, :, None], tps, axis=2)      # temporal repeat
        p = np.tile(p.reshape(h * w, -1), (t, 1))
        return p.astype(np.float32)

    def __call__(self, text, images=None, videos=None, padding=True,
                 return_tensors="np", truncation=False, max_length=None,
                 **_kw):
        seqs = [self.tokenizer(t)["input_ids"] for t in text]
        if truncation and max_length:
            seqs = [s[:max_length] for s in seqs]
        width = max(len(s) for s in seqs)
        if padding == "max_length" and max_length:
            width = max_length
        pad = self.tokenizer.pad_token_id
        batch = {
            "input_ids": np.asarray(
                [s + [pad] * (width - len(s)) for s in seqs], np.int64),
            "attention_mask": np.asarray(
                [[1] * len(s) + [0] * (width - len(s)) for s in seqs],
                np.int64),
        }
        if images is not None:
            flat = [self._patchify(i) for imgs in images for i in imgs]
            if flat:
                batch["pixel_values"] = np.concatenate(flat, axis=0)
                batch["image_grid_thw"] = np.asarray(
                    [list(self.grid)] * len(flat), np.int64)
        if videos is not None:
            flat = [self._patchify(v, self.video_grid)
                    for vids in videos for v in vids]
            if flat:
                batch["pixel_values_videos"] = np.concatenate(flat, axis=0)
                batch["video_grid_thw"] = np.asarray(
                    [list(self.video_grid)] * len(flat), np.int64)
                batch["second_per_grid_ts"] = np.asarray(
                    [self.second_per_grid_t] * len(flat), np.float64)
        return batch


def make_mock_video_dataset(num_samples: int = 32, image_size: int = 16,
                            num_frames: int = 4, seed: int = 0,
                            limit_dataset_samples: Optional[int] = None,
                            **_kw) -> List[dict]:
    """Synthetic video -> description conversations (the Qwen collator
    routes them through ``pixel_values_videos``, ``video_grid_thw`` and
    ``second_per_grid_ts``)."""
    rng = np.random.default_rng(seed)
    n = min(num_samples, limit_dataset_samples or num_samples)
    words = ["walk", "run", "jump", "spin", "fall", "rise", "wave"]
    out = []
    for _ in range(n):
        vid = rng.integers(
            0, 256, (num_frames, image_size, image_size, 3)).astype(np.uint8)
        desc = " ".join(rng.choice(words, size=5))
        out.append({
            "conversation": [
                {"role": "user", "content": [
                    {"type": "video"},
                    {"type": "text", "text": "Describe this video."}]},
                {"role": "assistant", "content": [
                    {"type": "text", "text": desc}]},
            ],
            "videos": [vid],
        })
    return out


class Phi4MMProcessor:
    """``processor._target_: automodel_tpu.datasets.vlm.mock.
    Phi4MMProcessor``, with the real processor's class name
    (``COLLATE_FNS`` dispatches by it): ``[user, assistant]``
    conversations with an optional audio clip.  ``__call__`` cuts each clip
    into frames of ``input_size`` samples (a clip shorter than
    ``time_reduction`` frames is zero-padded to that many), puts
    ``ceil(frames / time_reduction)`` audio tokens before the row's text,
    and emits ``input_audio_embeds [N, T, input_size]`` (padded to the
    longest clip), ``audio_embed_sizes [N]`` and ``audio_attention_mask
    [N, T]``."""

    AUDIO_TOKEN = "<|audio|>"

    def __init__(self, vocab_size: int = 256, input_size: int = 20,
                 time_reduction: int = 4, audio_token_id: int = 6):
        self.input_size = input_size
        self.time_reduction = time_reduction
        self.audio_token_id = audio_token_id
        self.tokenizer = _MockTokenizer(vocab_size, image_token_id=0)
        self.tokenizer._special[self.AUDIO_TOKEN] = audio_token_id

    def apply_chat_template(self, conversation, tokenize=False, **_kw):
        parts = []
        for turn in conversation:
            parts.append("<user>" if turn["role"] == "user" else "<assistant>")
            content = turn["content"]
            parts.append(content if isinstance(content, str) else " ".join(
                c.get("text", "") for c in content))
        text = " ".join(parts)
        return self.tokenizer(text)["input_ids"] if tokenize else text

    def __call__(self, text, audios=None, padding=True, return_tensors="np",
                 truncation=False, max_length=None, **_kw):
        feats, sizes, seqs = [], [], []
        for i, t in enumerate(text):
            ids = self.tokenizer(t)["input_ids"]
            a = audios[i] if audios is not None else None
            if a is not None:
                arr, _sr = a if isinstance(a, tuple) else (a, 16000)
                arr = np.asarray(arr, np.float32)
                frames = max(len(arr) // self.input_size, self.time_reduction)
                need = frames * self.input_size
                if len(arr) < need:
                    arr = np.pad(arr, (0, need - len(arr)))
                feats.append(arr[:need].reshape(frames, self.input_size))
                n_tok = int(np.ceil(frames / self.time_reduction))
                ids = [self.audio_token_id] * n_tok + ids
                sizes.append(n_tok)
            seqs.append(ids)
        if truncation and max_length:
            seqs = [s[:max_length] for s in seqs]
        width = max(len(s) for s in seqs)
        pad = self.tokenizer.pad_token_id
        out = {"input_ids": np.asarray(
            [s + [pad] * (width - len(s)) for s in seqs], np.int64)}
        if feats:
            t_max = max(f.shape[0] for f in feats)
            out["input_audio_embeds"] = np.stack([
                np.pad(f, ((0, t_max - f.shape[0]), (0, 0))) for f in feats])
            out["audio_embed_sizes"] = np.asarray(sizes, np.int64)
            out["audio_attention_mask"] = np.asarray(
                [[1] * f.shape[0] + [0] * (t_max - f.shape[0])
                 for f in feats], np.int64)
        return out


def make_mock_audio_dataset(num_samples: int = 32, seed: int = 0,
                            **_kw) -> List[dict]:
    """``[user, assistant]`` conversations with an 80-200 sample clip each
    (the JAX rows from the same seed)."""
    rng = np.random.default_rng(seed)
    words = ["yes", "no", "music", "speech", "noise", "quiet", "loud"]
    out = []
    for _ in range(num_samples):
        audio = rng.normal(size=(rng.integers(80, 200),)).astype(np.float32)
        out.append({
            "conversation": [
                {"role": "user", "content": "What do you hear?"},
                {"role": "assistant",
                 "content": " ".join(rng.choice(words, size=4))},
            ],
            "audio": {"array": audio, "sampling_rate": 16000},
        })
    return out
