"""The port's mesh and sharding rules (``automodel_tpu_torch/distributed/
mesh.py``, ``shardings.py``) against the JAX package's on its virtual CPU
devices: over a grid of sizes and worlds 1-8 the same ``shape``,
accessors, cp layout and errors (sizing needs no process group: the port
takes ``world_size``); the same rule table and partition specs, the Llama
class's ``param_axes`` matching the JAX model's leaf by leaf; the rows of
a global batch each data coordinate holds; and, in 4 gloo ranks, the
``DeviceMesh`` the port builds puts each rank at the coordinate where the
JAX mesh puts the device of that index, and a signal one rank traps and
the ranks' timer values are gathered by every rank (the JAX
``process_allgather``s of ``utils/sig_utils.py`` and
``training/timers.py``).  All exact."""

import itertools

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from automodel_tpu.distributed import mesh as jm
from automodel_tpu.distributed import shardings as js
from automodel_tpu_torch.distributed import mesh as tm
from automodel_tpu_torch.distributed import shardings as ts
from tests.torch_dist import run_ranks
from tests.torch_dist_workers import mesh_layout, signals_and_timers

ACCESSORS = ("world_size", "dcn_dp_size", "pp_size", "dp_replicate_size",
             "dp_shard_size", "cp_size", "tp_size", "dp_size",
             "loss_reduce_size", "cp_layout", "shape",
             "sequence_parallel", "expert_parallel")

GRID = [dict(world=w, dp_size=dp, dp_replicate_size=rep, dcn_dp_size=dcn,
             tp_size=tp, cp_size=cp)
        for w, dp, rep, dcn, tp, cp in itertools.product(
            (1, 2, 3, 4, 6, 8), (None, 1, 2, 4), (1, 2), (1, 2), (1, 2, 4),
            (1, 2))
        if not (dp is not None and dp > 2 and rep * dcn > 1)]


def _both(world, **kw):
    out = []
    for build in (lambda: jm.MeshManager(devices=jax.devices()[:world], **kw),
                  lambda: tm.MeshManager(world_size=world, **kw)):
        try:
            out.append(build())
        except ValueError as e:
            out.append(e)
    return out


@pytest.mark.parametrize("case", GRID,
                         ids=["-".join(f"{v}" for v in c.values())
                              for c in GRID])
def test_sizing_equals_jax(case):
    case = dict(case)
    world = case.pop("world")
    j, t = _both(world, **case)
    if isinstance(j, Exception):
        assert isinstance(t, ValueError), t
        assert str(t) == str(j)
        return
    assert not isinstance(t, Exception), t
    for name in ACCESSORS:
        assert getattr(t, name) == getattr(j, name), name
    assert tm.MESH_AXES == jm.MESH_AXES
    for a, b in ((tm.DP_AXES, jm.DP_AXES), (tm.FSDP_AXES, jm.FSDP_AXES),
                 (tm.LOSS_AXES, jm.LOSS_AXES),
                 (tm.BATCH_AXES, jm.BATCH_AXES)):
        assert a == b
    # a dcn_dp slice is a contiguous block of ranks, as JAX's emulated
    # slices are of device ids
    for s in range(j.dcn_dp_size):
        assert list(t.slice_processes(s)) == [d.id for d in
                                              j.slice_devices(s)]


@pytest.mark.parametrize("kw", [dict(cp_size=2), dict(cp_size=2,
                                                      cp_layout="contiguous"),
                                dict(cp_size=1, cp_layout="zigzag"),
                                dict(cp_layout="none"),
                                dict(cp_layout="ring"),
                                dict(sequence_parallel=True, tp_size=2),
                                dict(expert_parallel=True)])
def test_layout_and_flags_equal_jax(kw):
    j, t = _both(4, **kw)
    if isinstance(j, Exception):
        assert str(t) == str(j)
        return
    assert (t.cp_layout, t.sequence_parallel, t.expert_parallel) == (
        j.cp_layout, j.sequence_parallel, j.expert_parallel)


def test_unknown_keys_warn_or_raise_as_jax(caplog):
    with pytest.raises(TypeError) as je:
        jm.MeshManager(devices=jax.devices()[:1], dcn_dp_sise=2, strict=True)
    with pytest.raises(TypeError) as te:
        tm.MeshManager(world_size=1, dcn_dp_sise=2, strict=True)
    assert "dcn_dp_sise" in str(te.value) and "dcn_dp_sise" in str(je.value)
    caplog.clear()
    tm.build_mesh({"_target_": "x", "dcn_dp_sise": 2}, world_size=1)
    assert "dcn_dp_sise" in caplog.text


def test_pipeline_and_elastic_raise_with_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 12"):
        tm.MeshManager(world_size=2, pp_size=2)
    mm = tm.MeshManager(world_size=4, dcn_dp_size=2)
    for fn in (lambda: mm.shrink_slices(0), lambda: mm.grow_slices()):
        with pytest.raises(NotImplementedError, match="item 12"):
            fn()


def test_one_process_mesh_raises_naming_torchrun():
    """A mesh larger than 1 in one process without a process group is not
    ported: the JAX sizing message and the launch the port needs; sized
    for a given world, the JAX error as it is."""
    with pytest.raises(NotImplementedError, match="world size 1 not "
                       "divisible by tp\\*cp\\*pp=2: .*torchrun"):
        tm.MeshManager(tp_size=2)
    with pytest.raises(ValueError) as e:
        tm.MeshManager(world_size=1, tp_size=2)
    assert "torchrun" not in str(e.value)


@pytest.mark.parametrize("mesh", [dict(tp_size=2), dict(cp_size=2)])
def test_tp_cp_gate_asks_the_model_what_it_runs(mesh):
    """Tensor and context parallelism take a model that runs Llama's own
    decoder methods, whatever its class is named: a subclass that keeps
    them gets past the gate (to the process-group check), one named
    ``LlamaForCausalLM`` that replaces its MLP is refused."""
    from automodel_tpu_torch.models.deepseek_v3 import DeepseekV3ForCausalLM
    from automodel_tpu_torch.models.gemma3 import Gemma3ForCausalLM
    from automodel_tpu_torch.models.granite import GraniteForCausalLM
    from automodel_tpu_torch.models.llama import LlamaConfig
    from automodel_tpu_torch.models.llama import LlamaForCausalLM as Llama
    from automodel_tpu_torch.models.mixtral import MixtralForCausalLM
    from automodel_tpu_torch.models.olmo2 import Olmo2ForCausalLM
    from automodel_tpu_torch.models.phi3 import Phi3ForCausalLM

    assert Llama.supports_tp_cp() and GraniteForCausalLM.supports_tp_cp()
    for cls in (MixtralForCausalLM, Phi3ForCausalLM, Olmo2ForCausalLM,
                Gemma3ForCausalLM, DeepseekV3ForCausalLM):
        assert not cls.supports_tp_cp(), cls.__name__

    class KeepsTheDecoder(Llama):
        pass

    class LlamaForCausalLM(Llama):
        def _mlp_block(self, x, layer):
            return super()._mlp_block(x, layer)

    cfg = LlamaConfig(vocab_size=64, hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=2)
    mm = tm.MeshManager(world_size=2, **mesh)
    model = KeepsTheDecoder(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="needs a process group"):
        ts.build_parallel_plan(model, mm).apply(model)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        ts.build_parallel_plan(model, mm).apply(model)


@pytest.mark.parametrize("sp,ep,pp", list(itertools.product((False, True),
                                                            repeat=3)))
def test_rules_and_specs_equal_jax(sp, ep, pp):
    jr = js.default_rules(sp, ep, pp)
    tr = ts.default_rules(sp, ep, pp)
    assert tr == jr
    for axes in [("embed", "heads"), ("act_batch", "act_seq", None),
                 ("vocab", "embed"), (None, "mlp", None), ("layers",),
                 ("act_tokens", "expert_mlp"), ("experts", "embed", None)]:
        assert ts.spec_for(axes, tr) == tuple(js.spec_for(axes, jr))
    with pytest.raises(KeyError):
        ts.spec_for(("embd",), tr)


def test_llama_param_axes_match_jax_leaves():
    from automodel_tpu.models.llama import LlamaConfig as JC
    from automodel_tpu.models.llama import LlamaForCausalLM as JL
    from automodel_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from automodel_tpu_torch.models.weights import jax_leaves

    for tied in (True, False):
        kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, tie_word_embeddings=tied,
                  attention_bias=True, qk_norm=True)
        jaxes = JL(JC(**kw)).param_axes()
        model = LlamaForCausalLM(LlamaConfig(**kw), device="cpu")
        taxes = model.param_axes()
        names = {id(p): n for n, p in model.named_parameters()}
        seen = 0
        for path, target, transposed in jax_leaves(model):
            want = jaxes
            for key in path:
                want = want[key]
            want = tuple(a for a in want if a != "layers")
            for p in (target if isinstance(target, list) else [target]):
                got = taxes[names[id(p)]]
                assert got == (want[::-1] if transposed else want), path
                seen += 1
        assert seen == len(taxes)
        specs = ts.param_partition_specs(model)
        assert specs["embed_tokens.weight"] == ("tp", ("dp_shard", "cp"))


@pytest.mark.parametrize("kw", [dict(dp_size=4), dict(dp_size=2, cp_size=2),
                                dict(dp_size=2, tp_size=2),
                                dict(dp_replicate_size=2, dp_size=4),
                                dict(dcn_dp_size=2, dp_size=8),
                                dict(dcn_dp_size=2, dp_replicate_size=2,
                                     dp_size=4, cp_size=2)])
def test_batch_rows_equal_jax_devices(kw):
    world = 8 if kw.get("dcn_dp_size") == 2 and kw.get("dp_size") == 8 \
        or kw.get("cp_size") == 2 and kw.get("dcn_dp_size") else 4
    j = jm.MeshManager(devices=jax.devices()[:world], **kw)
    t = tm.MeshManager(world_size=world, **kw)
    G = 2 * t.dp_size
    rows = ts.batch_rows_by_process(t, G)
    sh = NamedSharding(j.mesh, P(jm.BATCH_AXES))
    by_dev = sh.devices_indices_map((G,))
    for r, dev in enumerate(j.mesh.devices.flat):
        want = np.arange(G)[by_dev[dev][0]]
        np.testing.assert_array_equal(rows[r], want)


def test_device_mesh_places_ranks_as_jax(tmp_path):
    cases = [dict(dp_size=2, cp_size=2), dict(dp_size=2, tp_size=2),
             dict(dp_replicate_size=2, dp_size=4),
             dict(dcn_dp_size=2, dp_size=4)]
    got = run_ranks(mesh_layout, 4, tmp_path, cases, timeout=120)
    for c, case in enumerate(cases):
        j = jm.MeshManager(devices=jax.devices()[:4], **case)
        for r in range(4):
            coord, groups = got[r][c]
            pos = np.argwhere(np.vectorize(lambda d: d.id)(j.mesh.devices)
                              == r)[0]
            assert tuple(coord[a] for a in jm.MESH_AXES) == tuple(pos)
            for axes, ranks in groups.items():
                # the group of ``axes`` is every rank that shares the
                # other coordinates
                same = [q for q in range(4) if all(
                    got[q][c][0][a] == coord[a] for a in jm.MESH_AXES
                    if a not in axes)]
                assert sorted(ranks) == same, (case, axes)


@pytest.fixture(scope="module")
def gathers(tmp_path_factory):
    return run_ranks(signals_and_timers, 4, tmp_path_factory.mktemp("g"),
                     timeout=120)


def test_signal_and_timers_gather_over_ranks(gathers):
    for before, after, stats, _ in gathers:
        assert (before, after) == (False, True)
        assert stats["step"] == {"min": 0.0, "max": 3.0, "mean": 1.5}
        assert stats["absent"] == {"min": 0.0, "max": 0.0, "mean": 0.0}


def test_ranked_rng_offsets_by_host_as_jax_process_index(gathers):
    """``ranked: true`` offsets the seed by the host (JAX's
    ``jax.process_index()``, 0 for every device of one host), not the
    rank: the 4 ranks of one host draw the same model; another host's
    ranks draw another (the repair: the rank offset made 4 models)."""
    from automodel_tpu.training.rng import StatefulRNG as JaxRNG

    seeds = {g[3][0] for g in gathers}
    assert len(seeds) == 1
    (eff, stream), (eff2, stream2) = gathers[0][3]
    assert eff == JaxRNG(seed=1111, ranked=True)._effective_seed
    assert eff2 == eff + 1 and stream2 != stream
    assert {g[3][1] for g in gathers} == {(eff2, stream2)}


@pytest.mark.parametrize("spec", [("tp", ("dp_shard", "cp")),
                                  (("dp_shard", "cp"), "tp"),
                                  (None, "tp"), ("dp_shard",), ()])
def test_placements_shard_as_jax_named_sharding(spec):
    """The DTensor placements of a spec cut a tensor into JAX's shard
    shape on the same mesh."""
    from torch.distributed.tensor import Shard

    j = jm.MeshManager(devices=jax.devices()[:8], dp_size=2, cp_size=2,
                       tp_size=2)
    shape = (8, 16)
    want = NamedSharding(j.mesh, P(*spec)).shard_shape(shape)
    got = list(shape)
    for axis, pl in zip(tm.MESH_AXES, ts.placements_for(spec)):
        if isinstance(pl, Shard):
            got[pl.dim] //= dict(zip(tm.MESH_AXES, j.shape))[axis]
    assert tuple(got) == tuple(want)
