"""Decoding with the dense cache against the JAX package on the CPU, fp32:
the Llama class's prefill repair, the VLMs' cached decode and
``automodel_tpu_torch/examples/vlm_generate.py``.

* The Llama class's prefill with a cache attends its own keys through
  ``ops/attention.py::attention`` (one plain forward a layer on the CPU,
  counted by ``splash_attention.plain_fwd_calls``; kernel 9 on the card),
  the prompt padding folded into segments: on left-padded prompts the
  prefill's logits equal JAX's cached prefill within 1e-5 relative
  (measured: about 1e-7), and the greedy tokens equal JAX's
  ``generate()``.
* The cached decode equals the full forward (within 1e-5 relative of the
  logits' largest magnitude; measured: about 1e-6) for Gemma-3 (five
  sliding layers with window 8 and a full one, rows past the window) and
  Gemma-2 (attention soft cap 50 and the final cap 30, which JAX decodes
  too: its Gemma-2 inherits Gemma-3's cached layer), llava and Gemma-3-VL
  with images, Qwen2.5-VL with an image (the rotary on 1-D positions on
  both sides) and Phi-4-multimodal with audio clips of two lengths.
* Greedy tokens equal to JAX's ``generate()`` for each of those, with
  images, a video and audio on the prefill, on right-padded prompts of
  two lengths that both ``generate()``s left-align (the features follow
  their placeholders, per row or in the batch's order).
* The generate script on a consolidated export (a tiny llava written by
  the port), in both packages, ``AutoProcessor.from_pretrained`` patched
  to the mock processor and the models built in fp32: the same text; an
  Orbax checkpoint raises ROADMAP item 7's ``NotImplementedError``.
* Gemma-3n still refuses a cache (text and multimodal), as in JAX.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.generation import GenerationConfig as JaxGenerationConfig
from automodel_tpu.generation import generate as jax_generate
from automodel_tpu_torch.generation import GenerationConfig, generate
from automodel_tpu_torch.models import hf_io
from automodel_tpu_torch.ops import splash_attention as sa
from tests import test_torch_gemma3 as tg3
from tests import test_torch_gemma3n as tg3n
from tests import test_torch_phi4_mm as tphi
from tests import test_torch_qwen25_vl as tqw
from tests import test_torch_vlm as tvlm
from tests.torch_serving_pair import build_models

torch.set_num_threads(1)

REL = 1e-5


@pytest.fixture(scope="module")
def llama():
    return build_models()


def test_llama_prefill_attends_through_the_dispatcher(llama):
    jm, params, tm = llama
    rng = np.random.default_rng(1)
    lens = np.asarray([9, 6, 13, 5])
    ids = np.zeros((4, 13), np.int64)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.integers(1, 255, n)
    sa.plain_fwd_calls = 0
    got = generate(tm, ids, lens, GenerationConfig(max_new_tokens=6))
    assert sa.plain_fwd_calls == tm.config.num_hidden_layers
    want = jax_generate(jm, params, ids, prompt_lens=lens,
                        config=JaxGenerationConfig(max_new_tokens=6))
    np.testing.assert_array_equal(got, np.asarray(want))
    # the prefill's logits, as generate() makes its first forward
    B, S = ids.shape
    shift = S - lens
    left = np.stack([np.roll(ids[b], shift[b]) for b in range(B)])
    mask = np.arange(S + 6)[None] >= shift[:, None]
    pos = np.maximum(np.arange(S)[None] - shift[:, None], 0)
    jout = jm(jax.tree.map(jnp.asarray, params), jnp.asarray(left),
              position_ids=jnp.asarray(pos), attention_mask=jnp.asarray(mask),
              kv_cache=jm.init_kv_cache(B, S + 6), cache_index=0)
    ref = np.asarray(jout["logits"])
    with torch.no_grad():
        out = tm(torch.from_numpy(left), position_ids=torch.from_numpy(pos),
                 attention_mask=torch.from_numpy(mask),
                 kv_cache=tm.init_kv_cache(B, S + 6), cache_index=0)
    keep = mask[:, :S]
    np.testing.assert_allclose(out["logits"].numpy()[keep], ref[keep],
                               rtol=REL, atol=REL * np.abs(ref).max())


# --- the families: (JAX model, params, port model, prefill keywords, ids)
def _gemma(name):
    jm, params, model = tg3.make_pair(name)
    return jm, params, model, {}, 128


def _vlm(name):
    jm, params, model = tvlm.make_pair(name)
    tokens = tvlm.FAMILIES[name][1]
    rng = np.random.default_rng(4)
    B, S = 2, tokens + 10
    ids = rng.integers(8, 96, (B, S))
    ids[:, 2:2 + tokens] = tvlm.IMG
    pv = rng.normal(size=(B, 1, 16, 16, 3)).astype(np.float32)
    return jm, params, model, {"pixel_values": pv}, ids


def _qwen():
    jm, params, model = tqw.make_pair(image_grid=tqw.IMAGE_GRID,
                                      video_grid=tqw.VIDEO_GRID)
    rows = tqw._rows("image", B=2, S=40)
    kw = {"pixel_values": rows["pixel_values"]}
    return jm, params, model, kw, rows["input_ids"].astype(np.int64)


def _qwen_video():
    jm, params, model, _, _ = _qwen()
    rows = tqw._rows("video", B=2, S=40)
    kw = {"pixel_values_videos": rows["pixel_values_videos"]}
    return jm, params, model, kw, rows["input_ids"].astype(np.int64)


def _phi():
    jm, params, model = tphi._pair()
    rng = np.random.default_rng(6)
    batch = tphi._audio_batch(rng)
    # the clips' placeholders first, left-aligned rows: no padding tail
    ids = batch["input_ids"].astype(np.int64)
    ids = np.where(ids == 0, 9, ids)
    kw = {k: batch[k] for k in ("input_audio_embeds", "audio_embed_sizes",
                                "audio_attention_mask")}
    return jm, params, model, kw, ids


CASES = {"gemma3": lambda: _gemma("gemma3"),
         "gemma2": lambda: _gemma("gemma2"),
         "llava": lambda: _vlm("llava"),
         "gemma3_vl": lambda: _vlm("gemma3"),
         "qwen25_vl_image": _qwen, "qwen25_vl_video": _qwen_video,
         "phi4_mm_audio": _phi}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jm, params, model, kw, ids = CASES[request.param]()
    if isinstance(ids, int):              # a text decoder: seeded ids
        ids = np.random.default_rng(2).integers(2, ids, (2, 20))
    return request.param, jm, params, model, kw, ids


def _tensors(kw):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}


def test_cached_decode_equals_the_full_forward(case):
    name, _, _, model, kw, ids = case
    B, S = ids.shape
    P = S - 4                       # prefill, then four single-token steps
    t = torch.from_numpy(ids)
    with torch.no_grad():
        pos = torch.arange(S).expand(B, S)
        full = model(t, position_ids=pos, **_tensors(kw))["logits"].numpy()
        cache = model.init_kv_cache(B, S)
        mask = torch.ones(B, S, dtype=torch.bool)
        steps = [model(t[:, :P], position_ids=pos[:, :P],
                       attention_mask=mask, kv_cache=cache, cache_index=0,
                       **_tensors(kw))["logits"]]
        for i in range(P, S):
            steps.append(model(t[:, i:i + 1], position_ids=pos[:, i:i + 1],
                               attention_mask=mask, kv_cache=cache,
                               cache_index=i)["logits"])
    got = torch.cat(steps, dim=1).numpy()
    np.testing.assert_allclose(got, full, rtol=REL,
                               atol=REL * np.abs(full).max(), err_msg=name)


def test_greedy_tokens_equal_jax_generate(case):
    name, jm, params, model, kw, ids = case
    # right-padded prompts of two lengths (the second's text tail cut),
    # which generate() left-aligns: the features follow their
    # placeholders
    S = ids.shape[1]
    lens = np.asarray([S, S - 4])
    ids = ids.copy()
    ids[1, S - 4:] = 0
    cfg = dict(max_new_tokens=8)
    want = jax_generate(jm, jax.tree.map(jnp.asarray, params), ids,
                        prompt_lens=lens, config=JaxGenerationConfig(**cfg),
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = generate(model, ids, lens, config=GenerationConfig(**cfg), **kw)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)


def test_gemma3n_still_refuses_a_cache():
    _, _, text = tg3n._text_pair()
    with pytest.raises(NotImplementedError, match="cacheless"):
        generate(text, np.ones((1, 4), np.int64),
                 config=GenerationConfig(max_new_tokens=2))
    vl = tg3n._port_vl()
    with pytest.raises(NotImplementedError, match="cacheless"):
        generate(vl, np.ones((1, 4), np.int64),
                 config=GenerationConfig(max_new_tokens=2))


class _Tokenizer:
    """The mock tokenizer plus the surface the script reads."""

    def __init__(self, inner):
        self._inner = inner
        self.pad_token_id = inner.pad_token_id
        self.eos_token_id = 2

    def __call__(self, *a, **kw):
        return self._inner(*a, **kw)

    def decode(self, row, skip_special_tokens=True):
        return " ".join(str(int(t)) for t in row)


def _mock_processor(package):
    import importlib

    mock = importlib.import_module(f"{package}.datasets.vlm.mock")
    proc = mock.MockVLMProcessor(vocab_size=96, image_size=16, patch_size=4,
                                 image_token_id=tvlm.IMG)
    proc.tokenizer = _Tokenizer(proc.tokenizer)
    return proc


def _load_jax_script():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "vlm_generate",
        "generate.py")
    spec = importlib.util.spec_from_file_location("jax_vlm_generate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fp32_from_pretrained(monkeypatch, cls, **kw):
    orig = cls.from_pretrained
    monkeypatch.setattr(cls, "from_pretrained", staticmethod(
        lambda path, **more: orig(path, compute_dtype="float32",
                                  **{**kw, **more})))


def test_generate_script_matches_jax_on_an_export(tmp_path, monkeypatch,
                                                  capsys):
    import transformers
    from PIL import Image

    from automodel_tpu.models.auto_model import (
        AutoModelForImageTextToText as JaxAuto,
    )
    from automodel_tpu_torch.examples import vlm_generate
    from automodel_tpu_torch.models.auto_model import (
        AutoModelForImageTextToText,
    )
    jax_script = _load_jax_script()

    _, _, model = tvlm.make_pair("llava")
    export = tmp_path / "model"
    hf_io.save_hf_weights(model, str(export))
    img = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (20, 24, 3)).astype(np.uint8)).save(img)
    _fp32_from_pretrained(monkeypatch, AutoModelForImageTextToText,
                          device="cpu")
    _fp32_from_pretrained(monkeypatch, JaxAuto)
    args = ["--checkpoint-path", str(export), "--base-model", str(export),
            "--prompt", "what is here", "--image", str(img),
            "--max-new-tokens", "6"]
    texts = []
    for package, run in (("automodel_tpu_torch", lambda: vlm_generate.main(
            args + ["--device", "cpu"])), ("automodel_tpu",
                                           lambda: jax_script.main(args))):
        monkeypatch.setattr(transformers.AutoProcessor, "from_pretrained",
                            lambda *a, p=package, **k: _mock_processor(p))
        run()
        texts.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert texts[0] == texts[1]
    assert len(texts[0].split()) >= 1


def test_generate_script_refuses_an_orbax_checkpoint(tmp_path):
    from automodel_tpu_torch.examples import vlm_generate

    ckpt = tmp_path / "epoch_0_step_2"
    ckpt.mkdir()
    args = ["--checkpoint-path", str(ckpt), "--prompt", "x", "--image",
            "x.png", "--device", "cpu"]
    with pytest.raises(SystemExit, match="base-model"):
        vlm_generate.main(args)
    with pytest.raises(NotImplementedError, match="Orbax"):
        vlm_generate.main(args + ["--base-model", str(tmp_path)])
