"""Shared pieces of the tests that feed both packages HF directories,
dataset rows and a tokenizer made here (nothing is downloaded).

* :class:`ByteTokenizer`: a duck-typed HF tokenizer over bytes (ids 4 ..
  259; pad 0, bos 1, eos 2, a start-of-turn marker 3), called on a string
  or a list of strings; a bos is prepended unless ``add_special_tokens``
  is False.  :class:`ChatByteTokenizer` adds a chat template
  (``apply_chat_template``: ``<sot> role: content <eos>`` per message).
* :func:`hellaswag_rows` / :func:`squad_rows`: rows in each dataset's
  schema, made from a seed.
* :func:`write_jsonl`, :func:`hf_cache_snapshot`: a jsonl file, and an
  ``$HF_HOME/hub/models--<org>--<name>/snapshots/<rev>`` copy of a
  directory with its ``refs/main``.
* :func:`jax_side_datasets`: the JAX package's dataset code served from
  rows in memory, in this process.
"""

import copy
import json
import os
import re
import shutil

import numpy as np

PAD, BOS, EOS, SOT = 0, 1, 2, 3
_SPECIAL = {"<pad>": PAD, "<s>": BOS, "</s>": EOS, "<sot>": SOT}
WORDS = ("the", "a", "man", "woman", "dog", "ball", "kitchen", "river",
         "then", "slowly", "runs", "jumps", "takes", "puts", "into", "over",
         "while", "his", "her", "bright", "water", "table", "rope", "hand")


class ByteTokenizer:
    """Bytes as ids (``b + 4``), a bos in front unless
    ``add_special_tokens`` is False; the special names map to their ids."""

    pad_token, bos_token, eos_token = "<pad>", "<s>", "</s>"
    pad_token_id, bos_token_id, eos_token_id = PAD, BOS, EOS
    all_special_ids = [PAD, BOS, EOS, SOT]

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size

    def encode(self, text: str, add_special_tokens: bool = True):
        if text in _SPECIAL:
            ids = [_SPECIAL[text]]
        else:
            ids = [b + 4 for b in text.encode()]
        return ([BOS] if add_special_tokens else []) + ids

    def __call__(self, text, add_special_tokens: bool = True):
        if isinstance(text, str):
            ids = self.encode(text, add_special_tokens)
            return {"input_ids": ids, "attention_mask": [1] * len(ids)}
        ids = [self.encode(t, add_special_tokens) for t in text]
        return {"input_ids": ids,
                "attention_mask": [[1] * len(i) for i in ids]}


class ChatByteTokenizer(ByteTokenizer):
    """:class:`ByteTokenizer` with a chat template."""

    chat_template = "<sot>{role}: {content}</s>"

    def apply_chat_template(self, messages):
        ids = [BOS]
        for m in messages:
            ids += ([SOT] + self.encode(f"{m['role']}: {m['content']}",
                                        add_special_tokens=False) + [EOS])
        return ids


def _text(rng, lo: int, hi: int) -> str:
    n = int(rng.integers(lo, hi + 1))
    return " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n))


def hellaswag_rows(n: int, seed: int, ctx_words=(4, 10),
                   ending_words=(2, 5)):
    """HellaSwag's schema: ``ctx``, four ``endings``, ``label`` (a string,
    as the published set stores it)."""
    rng = np.random.default_rng(seed)
    return [{"ind": i, "ctx": _text(rng, *ctx_words),
             "endings": [_text(rng, *ending_words) for _ in range(4)],
             "label": str(int(rng.integers(0, 4)))} for i in range(n)]


def squad_rows(n: int, seed: int, context_words=(6, 14),
               question_words=(3, 6)):
    """SQuAD's schema: ``context``, ``question``, ``answers: {text,
    answer_start}`` (the answer a span of the context)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        ctx = _text(rng, *context_words)
        words = ctx.split()
        a = int(rng.integers(0, len(words)))
        answer = " ".join(words[a:a + int(rng.integers(1, 3))])
        rows.append({"id": str(i), "title": "t", "context": ctx,
                     "question": _text(rng, *question_words) + "?",
                     "answers": {"text": [answer],
                                 "answer_start": [ctx.find(answer)]}})
    return rows


def write_jsonl(path: str, rows) -> str:
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return path


def hf_cache_snapshot(hf_home: str, repo_id: str, src_dir: str,
                      rev: str = "0123abcd") -> str:
    """Copy ``src_dir`` into ``hf_home`` as the snapshot ``rev`` of
    ``repo_id``, with ``refs/main`` naming it; returns the snapshot."""
    repo = os.path.join(hf_home, "hub", "models--" + repo_id.replace("/",
                                                                      "--"))
    snap = os.path.join(repo, "snapshots", rev)
    shutil.copytree(src_dir, snap)
    os.makedirs(os.path.join(repo, "refs"), exist_ok=True)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(rev)
    return snap


def jax_side_datasets(monkeypatch, by_split=None):
    """The ``datasets`` package as the JAX dataset code meets it here:
    ``load_dataset`` (any repo id) answers from ``by_split`` (``split`` or
    ``split[:n]``), so nothing is read from disk or the network, and
    ``Dataset.map`` runs in this process (its ``num_proc=1`` forks a
    worker, which a process running JAX's threads must not do)."""
    import datasets

    real_map = datasets.Dataset.map

    def map_in_process(self, *args, num_proc=None, **kwargs):
        return real_map(self, *args, **kwargs)

    monkeypatch.setattr(datasets.Dataset, "map", map_in_process)
    if by_split is None:
        return

    def load_dataset(name, split=None, **_):
        m = re.fullmatch(r"(\w+)(?:\[:(\d+)\])?", split)
        rows = by_split[m.group(1)]
        if m.group(2):
            rows = rows[:int(m.group(2))]
        return datasets.Dataset.from_list(copy.deepcopy(rows))

    monkeypatch.setattr(datasets, "load_dataset", load_dataset)
