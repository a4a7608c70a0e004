"""The port's production-mesh sharding rules against the JAX reference's
(`repro.launch.mesh`), on the reference tests' `FakeMesh` (axis sizes
only), and the registry's long-context variant and shape rule.

* `param_pspecs`: the port's specs, restacked into the reference's
  layout (each per-layer spec with the layer axis's None in front, every
  repeat the same), equal the reference's for all 10 archs x {single
  (16, 16), multi-pod (2, 16, 16)} x `fsdp` in {False, True}.
* `cache_pspecs`: every LM arch at `decode_32k` on both meshes, and the
  four archs of the reference's `test_cache_specs_divisible` in their
  long-context variant; a ring's `pos` (a host int in the port) takes
  the reference's P().
* `batch_pspecs`: every arch x input shape on both meshes, and the
  batch-1 fallback to the sequence dim.
* `opt_pspecs`: AdamW's moments take the params' specs, the step ().
* `supports_shape` equals the reference's for all 40 (arch, shape)
  pairs, and `make_groups(long_context=True)` gives every block the
  reference's window.

Specs are compared exactly (a PartitionSpec as the tuple of its
entries).
"""
import dataclasses
import functools

import jax
import pytest
import torch

from repro import optim as joptim
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import mesh as jmesh
from repro.models import build_model as jbuild_model
from repro.models import input_specs as jinput_specs
from repro.models import supports_shape as jsupports_shape
from repro.models.lm import make_groups as jmake_groups
from repro_torch import optim
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, all_configs, get_config
from repro_torch.launch import mesh as meshlib
from repro_torch.models import build_model, input_specs, supports_shape
from repro_torch.models.lm import make_groups
from _torch_threads import one_torch_thread

one_torch_thread()


@dataclasses.dataclass
class FakeMesh:
    shape: dict
    axis_names: tuple


SINGLE = FakeMesh({"data": 16, "model": 16}, ("data", "model"))
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16},
                 ("pod", "data", "model"))
MESHES = {"single": SINGLE, "multi": MULTI}
LM_ARCHS = [a for a in ARCH_IDS if a != "whisper_base"]
_LAYER_STACKS = ("enc_blocks", "dec_blocks")


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def ref_flat(specs) -> dict:
    """path -> spec tuple of a reference spec tree."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=_is_spec)[0]:
        out[tuple(jmesh.nn._path_elem_str(p) for p in path)] = tuple(s)
    return out


def port_flat(specs, path=()) -> dict:
    """path -> spec of a port spec tree (dicts and lists; tuples are
    specs)."""
    if isinstance(specs, dict):
        out = {}
        for k in specs:
            out.update(port_flat(specs[k], path + (str(k),)))
        return out
    if isinstance(specs, list):
        out = {}
        for i, v in enumerate(specs):
            out.update(port_flat(v, path + (str(i),)))
        return out
    return {path: specs}


def _stacked(reps: list):
    """One stacked spec tree from a group's per-repeat spec trees: every
    repeat's the same, the layer axis replicated in front (a cursor's
    () stays)."""
    for r in reps[1:]:
        assert r == reps[0]

    def lead(s):
        if isinstance(s, dict):
            return {k: lead(v) for k, v in s.items()}
        return s if s == () else (None,) + s
    return lead(reps[0])


def restack(specs):
    """A port spec tree in the reference's stacked layout."""
    if isinstance(specs, dict):
        return {k: [_stacked(g) for g in v] if k == "groups"
                else _stacked(v) if k in _LAYER_STACKS else restack(v)
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [restack(v) for v in specs]
    return specs


@functools.lru_cache(maxsize=None)
def _ref_params(arch, long_context=False):
    model = jbuild_model(jget_config(arch), long_context=long_context)
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch, long_context=False):
    model = build_model(get_config(arch), long_context=long_context)
    return model, model.init(torch.Generator(), "meta")


def test_arch_ids_and_configs_match_reference():
    assert ARCH_IDS == JARCH_IDS
    assert list(all_configs()) == ARCH_IDS
    assert list(INPUT_SHAPES) == list(JSHAPES)
    with pytest.raises(ValueError, match="no such architecture"):
        get_config("gpt_2")


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh, fsdp):
    m = MESHES[mesh]
    _, shapes = _ref_params(arch)
    want = ref_flat(jmesh.param_pspecs(shapes, m, fsdp=fsdp))
    _, params = _port_params(arch)
    got = port_flat(restack(meshlib.param_pspecs(params, m, fsdp=fsdp)))
    assert got == want


def test_tensor_and_expert_parallel_dims():
    """The reference's own spot checks, on the port's per-layer leaves."""
    _, params = _port_params("mistral_large_123b")
    blk = meshlib.param_pspecs(params, SINGLE)["groups"][0][0]["0"]
    assert blk["mixer"]["wq"]["w"] == (None, "model")
    assert blk["mixer"]["wo"]["w"] == ("model", None)
    assert blk["mlp"]["gate"]["w"] == (None, "model")
    assert blk["mlp"]["down"]["w"] == ("model", None)
    _, params = _port_params("qwen3_moe_30b_a3b")
    moe = meshlib.param_pspecs(params, SINGLE)["groups"][0][5]["0"]["mlp"]
    assert moe["gate"] == ("model", None, None)
    assert moe["down"] == ("model", None, None)


def _ref_caches(arch, shape, long_context):
    model, pshapes = _ref_params(arch, long_context)
    if model.cfg.encdec:
        feats = jinput_specs(model.cfg, shape)["audio_feats"]
        return jax.eval_shape(
            functools.partial(model.init_cache, max_len=shape.seq_len),
            pshapes, feats)
    return jax.eval_shape(
        lambda: model.init_cache(shape.global_batch, shape.seq_len))


def _port_caches(arch, shape, long_context):
    model, params = _port_params(arch, long_context)
    if model.cfg.encdec:
        feats = input_specs(model.cfg, shape)["audio_feats"]
        return model.init_cache(params, feats, max_len=shape.seq_len)
    return model.init_cache(shape.global_batch, shape.seq_len, "meta")


CACHE_CASES = ([(a, False) for a in LM_ARCHS]
               + [(a, True) for a in ("qwen1_5_32b", "deepseek_v2_236b",
                                      "whisper_base", "mamba2_130m")])


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch,long_context", CACHE_CASES,
                         ids=[f"{a}{'-long' if lc else ''}"
                              for a, lc in CACHE_CASES])
def test_cache_specs_match_reference(arch, long_context, mesh):
    m = MESHES[mesh]
    shape = INPUT_SHAPES["decode_32k"]
    want = ref_flat(jmesh.cache_pspecs(
        _ref_caches(arch, JSHAPES["decode_32k"], long_context), m))
    got = meshlib.cache_pspecs(_port_caches(arch, shape, long_context), m)
    if isinstance(got, list):          # an LM's groups of repeats
        got = [_stacked(g) for g in got]
    assert port_flat(got) == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_reference(arch):
    for name, shape in INPUT_SHAPES.items():
        for m in MESHES.values():
            want = {k: tuple(s) for k, s in jmesh.batch_pspecs(
                jinput_specs(jget_config(arch), JSHAPES[name]), m).items()}
            got = meshlib.batch_pspecs(input_specs(get_config(arch), shape),
                                       m)
            assert got == want, (name, m.shape)


def test_batch_specs_fall_back_to_seq_for_batch1():
    spec = meshlib.batch_pspecs(
        {"tokens": torch.empty(1, 524288, dtype=torch.long,
                               device="meta")}, SINGLE)["tokens"]
    assert spec == (None, "data")
    spec = meshlib.batch_pspecs(
        {"tokens": torch.empty(1, 524288, dtype=torch.long,
                               device="meta")}, MULTI)["tokens"]
    assert spec == (None, ("pod", "data"))
    # neither dim divisible: replicated
    spec = meshlib.batch_pspecs(
        {"x": torch.empty(3, 5, 7, device="meta")}, SINGLE)["x"]
    assert spec == (None, None, None)


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "qwen3_moe_30b_a3b",
                                  "whisper_base"])
def test_opt_specs_mirror_params(arch):
    _, shapes = _ref_params(arch)
    ref_p = jmesh.param_pspecs(shapes, MULTI, fsdp=True)
    ref_opt = jax.eval_shape(joptim.adamw(3e-4).init, shapes)
    want = ref_flat(jmesh.opt_pspecs(ref_opt, ref_p))
    _, params = _port_params(arch)
    p_specs = meshlib.param_pspecs(params, MULTI, fsdp=True)
    o_specs = meshlib.opt_pspecs(optim.adamw(3e-4).init(params), p_specs)
    assert o_specs["step"] == ()
    assert o_specs["m"] == p_specs and o_specs["v"] == p_specs
    assert port_flat(restack(o_specs)) == want


def test_supports_shape_matches_reference():
    n_skip = 0
    for arch in ARCH_IDS:
        for name in INPUT_SHAPES:
            got = supports_shape(get_config(arch), INPUT_SHAPES[name])
            want = jsupports_shape(jget_config(arch), JSHAPES[name])
            assert got == want, (arch, name)
            n_skip += not got[0]
    assert n_skip == 1                 # whisper_base at long_500k


def _windows(groups) -> list:
    return [[(s.mixer, s.attn.window if s.attn is not None else None)
             for s in g.specs] + [g.n_repeat] for g in groups]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_long_context_windows_match_reference(arch):
    for long_context in (False, True):
        got = _windows(make_groups(get_config(arch),
                                   long_context=long_context))
        want = _windows(jmake_groups(jget_config(arch),
                                     long_context=long_context))
        assert got == want, long_context
    cfg = get_config(arch)
    if cfg.long_window:
        wins = {w for g in _windows(make_groups(cfg, long_context=True))
                for _, w in g[:-1]}
        assert wins <= {cfg.long_window, None}
        assert cfg.long_window in wins
