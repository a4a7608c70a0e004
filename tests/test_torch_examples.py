"""The four examples over the PyTorch port (`examples/torch_*.py`) on
the CPU, and their wire reports against the JAX reference's.

Each example's `main(["--device", "cpu"])` runs at the reference
script's sizes and steps and passes the script's own closing asserts
(the 100M driver at `--tiny` with fewer `--steps`, which the reference
script allows).  Each example's `Session.wire_report` (names, shapes,
directions, bytes) is exactly the reference's `Session.wire_report` for
the same plan and batch shape: wire shapes and bytes are static, so no
training is needed for that.  Without a GPU each example refuses to run
unless given `--device cpu`.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.api import Plan as JPlan
from repro.api import leakage_probe as jleakage_probe
from repro.api import lm_split_fns as jlm_split_fns
from repro.api import quantize_int8 as jquantize_int8
from repro.api import softmax_xent as jsoftmax_xent
from repro.configs import get_config as jget_config
from repro.core import split as jsp
from repro.models import build_model as jbuild_model
from repro.nn import convnets as JC
from repro.nn import layers as JL
from _torch_threads import one_torch_thread

one_torch_thread()

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
NAMES = ("quickstart", "multihop_tor", "multimodal_vertical",
         "e2e_train_100m")
E2E_STEPS = 60


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _report(rep):
    return [(w["name"], w["direction"], tuple(w["shape"]), w["bytes"])
            for w in rep]


# ---------------------------------------------------------------------------
# each example's main() on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_example_main_on_cpu(name):
    ex = _example(name)
    argv = ["--device", "cpu"]
    if name == "e2e_train_100m":
        argv += ["--tiny", "--steps", str(E2E_STEPS)]
    out = ex.main(argv)
    losses = out["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    if name == "e2e_train_100m":
        assert len(losses) == E2E_STEPS and out["steps"] == E2E_STEPS
        assert losses[-1] < losses[0] - 0.5
        assert out["client_gb"] > 0
    else:
        assert len(losses) == ex.STEPS
    if name == "multimodal_vertical":
        # the fused splitcat entry scores exactly as Session.evaluate
        assert out["accuracy"] > 0.8
        assert out["accuracy_fused"] == out["accuracy"]
        assert set(out["leakage"]) == {"radiology", "pathology"}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is visible")
@pytest.mark.parametrize("name", NAMES)
def test_example_needs_a_gpu_unless_told_cpu(name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])


# ---------------------------------------------------------------------------
# the wire reports against the reference's
# ---------------------------------------------------------------------------

def _lm_batch(vocab, batch, seq, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, seq + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])})


def _quickstart(ex):
    cfg = jget_config("phi4_mini_3_8b").reduced(vocab=128)
    jplan = JPlan(mode="vanilla", model=jlm_split_fns(jbuild_model(cfg),
                                                      ex.CUT),
                  cut=ex.CUT, n_clients=1, optimizer=joptim.adamw(5e-3),
                  wire=[jquantize_int8()])
    jb, tb = _lm_batch(cfg.vocab, ex.BATCH, ex.SEQ)
    return jplan, ex.make_plan(ex.config()), [jb], [tb]


def _e2e(ex):
    """The driver's `--tiny` plan (its ~100M model's init alone takes
    seconds in each package; the wire's shapes follow the same rule)."""
    tcfg, steps, batch, seq = ex.config(True)
    cfg = jget_config("phi4_mini_3_8b").reduced(vocab=256)
    cut = max(1, cfg.n_layers // 4)
    assert cut == ex.cut_of(tcfg)
    sched = joptim.schedules.warmup_cosine(3e-3, steps // 10, steps)
    jplan = JPlan(mode="vanilla", model=jlm_split_fns(jbuild_model(cfg), cut),
                  cut=cut, optimizer=joptim.adamw(sched, weight_decay=0.01),
                  clip_norm=1.0)
    jb, tb = _lm_batch(cfg.vocab, batch, seq)
    return jplan, ex.make_plan(ex.build_model(tcfg), cut, steps), [jb], [tb]


def _images(n, n_classes, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, n_classes, n)
    return ({"x": jnp.asarray(x), "labels": jnp.asarray(y, jnp.int32)},
            {"x": torch.from_numpy(x), "labels": torch.from_numpy(y)})


def _multihop(ex):
    cfg = JC.CNNConfig(name="hops", width_mult=0.25,
                       plan=(16, 16, "M", 32, "M"), n_classes=4)
    plan = JC.vgg_plan(cfg)
    model = jsp.list_segmodel(
        n_segments=len(plan), init=lambda k: JC.vgg_init(k, cfg),
        layer_apply=lambda p, i, x: JC.vgg_layer_apply(p, plan[i], x))
    jplan = JPlan(mode="multihop", model=model, cuts=ex.CUTS, n_clients=1,
                  loss_fn=jsoftmax_xent, optimizer=joptim.adamw(3e-3))
    jb, tb = _images(ex.ROWS, ex.N_CLASSES)
    return jplan, ex.make_plan(), [jb], [tb]


def _multimodal(ex):
    branch = jsp.Branch(
        init=lambda k: {"l1": JL.dense_init(k, ex.DIM, 40, bias=True),
                        "l2": JL.dense_init(k, 40, ex.DFEAT, bias=True)},
        apply=lambda p, x: JL.dense_apply(
            p["l2"], jax.nn.relu(JL.dense_apply(p["l1"], x))))
    jplan = JPlan(mode="vertical", branch=branch, n_clients=2,
                  trunk=(lambda k: JL.dense_init(k, 2 * ex.DFEAT,
                                                 ex.N_CLASSES, bias=True),
                         lambda p, f: JL.dense_apply(p, f)),
                  loss_fn=jsoftmax_xent, optimizer=joptim.adamw(5e-3),
                  wire=[jleakage_probe()])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, ex.ROWS, ex.DIM)).astype(np.float32)
    y = rng.integers(0, ex.N_CLASSES, ex.ROWS)
    return (jplan, ex.make_plan(),
            {"x": jnp.asarray(x), "labels": jnp.asarray(y, jnp.int32)},
            {"x": torch.from_numpy(x), "labels": torch.from_numpy(y)})


PLANS = {"quickstart": _quickstart, "multihop_tor": _multihop,
         "multimodal_vertical": _multimodal, "e2e_train_100m": _e2e}


@pytest.mark.parametrize("name", NAMES)
def test_example_wire_report_matches_reference(name):
    jplan, tplan, jb, tb = PLANS[name](_example(name))
    want = _report(jplan.compile().wire_report(jb))
    got = _report(tplan.compile(device="cpu").wire_report(tb))
    assert got == want and got
