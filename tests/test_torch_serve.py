"""The port's split serving against the JAX reference's `ServeSession`.

Same setup as `tests/test_serve.py:_setup`: reduced phi4-mini with
vocab 97, batch 2, prompt 7, 6 generated tokens, ring length 15, the
reference's parameters from PRNGKey(0) bridged over and its prompt from
PRNGKey(1).  For the dense, fake-q8, physical-q8 and fused-entry wires:

* generated tokens equal;
* last-position logits (prefill and the first decode step) allclose at
  1e-4;
* the reference's cut activation packed by the port: bitwise the
  reference's packed payload;
* `decode_cost(1)` / `prefill_cost` records equal record for record
  (names, logical shapes, dtypes, directions, bytes, physical flags).

Plus the package rules: no JAX or `repro` import anywhere in the port or
`chip_smoke.py`, no quiet CPU fallback, and the serving CLI.
"""
import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.wire import WireTape as JWireTape
from repro.configs import get_config as jget_config
from repro.core import wire_compress as jwc
from repro.core.split import record as jrecord
from repro.models import build_model as jbuild_model
from repro.serve import ServePlan as JServePlan
from repro.serve import ServeSession as JServeSession
from repro_torch import bridge
from repro_torch.api.wire import (WireAccountingError, WireStack, WireTape,
                                  WireTransform, parse_wire)
from repro_torch.configs import get_config
from repro_torch.core import wire_compress as twc
from repro_torch.core.split import record
from repro_torch.kernels import ops
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import ServePlan, ServeSession

ROOT = Path(__file__).resolve().parents[1]
B, S, GEN = 2, 7, 6
MAX_LEN = S + GEN + 2

WIRES = {"dense": ("", False), "fake_q8": ("quantize_int8", False),
         "physical_q8": ("quantize_int8:physical", False),
         "fused_entry": ("quantize_int8:physical", True)}
# what the reference generates on these seeds (fp32 and q8 part ways at
# token 3); the port must match it token for token
WANT_TOKENS = {
    "dense": [[71, 71, 71, 74, 0, 71], [41, 41, 41, 41, 36, 59]],
    "fake_q8": [[71, 71, 21, 75, 71, 70], [41, 41, 41, 41, 36, 59]],
}
WANT_TOKENS["physical_q8"] = WANT_TOKENS["fused_entry"] = \
    WANT_TOKENS["fake_q8"]


@pytest.fixture(scope="module")
def setup():
    cfg_j = jget_config("phi4_mini_3_8b").reduced(vocab=97)
    params_j = jbuild_model(cfg_j).init(jax.random.PRNGKey(0))
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                           cfg_j.vocab))
    cfg_t = get_config("phi4_mini_3_8b").reduced(vocab=97)
    params_t = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t)
    return cfg_j, params_j, cfg_t, params_t, prompt


def _sessions(setup, wire, fused):
    cfg_j, params_j, cfg_t, params_t, _ = setup
    js = JServeSession(JServePlan(arch=cfg_j, max_batch=B, max_len=MAX_LEN,
                                  wire=wire, fused_entry=fused), params_j)
    ts = ServeSession(ServePlan(arch=cfg_t, max_batch=B, max_len=MAX_LEN,
                                wire=wire, fused_entry=fused), params_t,
                      device="cpu")
    return js, ts


@pytest.mark.parametrize("wire", list(WIRES))
def test_generated_tokens_match_reference(setup, wire):
    js, ts = _sessions(setup, *WIRES[wire])
    prompt = setup[-1]
    want = np.asarray(js.generate(jnp.asarray(prompt), GEN))
    got = ts.generate(torch.from_numpy(prompt), GEN)
    assert got.shape == (B, GEN)
    assert want.tolist() == WANT_TOKENS[wire]
    assert got.tolist() == want.tolist()


def _step_logits_jax(js, prompt):
    m, cut = js.model, js.cut
    cc, sc = m.init_cache_split(B, MAX_LEN, cut)
    act, cc = m.prefill_client(js.client_params, {"tokens": prompt}, cut, cc)
    act = jrecord(JWireTape(js.stack), "prefill_act", act, "up")
    logits, sc = m.prefill_server(js.server_params, jwc.as_dense(act), cut, sc)
    tok = jnp.argmax(logits[:, -1], -1)[:, None]
    a, cc = m.decode_step_client(js.client_params, tok, cut, cc)
    a = jrecord(JWireTape(js.stack), "cut_act", a, "up")
    if js._fused is not None:
        step, _ = js._fused_server_decode(js.server_params, a, sc)
    else:
        step, _ = m.decode_step_server(js.server_params, jwc.as_dense(a), cut,
                                       sc)
    return np.asarray(logits[:, -1]), np.asarray(step[:, -1])


def _step_logits_port(ts, prompt):
    m, cut = ts.model, ts.cut
    cc, sc = m.init_cache_split(B, MAX_LEN, cut)
    act, cc = m.prefill_client(ts.client_params, {"tokens": prompt}, cut, cc)
    act = record(WireTape(ts.stack), "prefill_act", act, "up")
    logits, sc = m.prefill_server(ts.server_params, twc.as_dense(act), cut, sc)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    a, cc = m.decode_step_client(ts.client_params, tok, cut, cc)
    a = record(WireTape(ts.stack), "cut_act", a, "up")
    if ts._fused is not None:
        step, _ = ts._fused_server_decode(ts.server_params, ts._fused, a, sc)
    else:
        step, _ = m.decode_step_server(ts.server_params, twc.as_dense(a), cut,
                                       sc)
    return logits[:, -1].numpy(), step[:, -1].numpy()


@pytest.mark.parametrize("wire", list(WIRES))
def test_last_position_logits_match_reference(setup, wire):
    js, ts = _sessions(setup, *WIRES[wire])
    prompt = setup[-1]
    with torch.no_grad():
        got = _step_logits_port(ts, torch.from_numpy(prompt))
    want = _step_logits_jax(js, jnp.asarray(prompt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_port_packs_the_reference_cut_activation_bitwise(setup):
    cfg_j, params_j, *_ , prompt = setup
    m = jbuild_model(cfg_j)
    cp, _ = m.split_params(params_j, 1)
    cc, _ = m.init_cache_split(B, MAX_LEN, 1)
    act, _ = m.prefill_client(cp, {"tokens": jnp.asarray(prompt)}, 1, cc)
    want = jwc.pack_int8(act)
    got = twc.pack_int8(torch.from_numpy(np.array(act)))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert twc.payload_nbytes(got) == jwc.payload_nbytes(want)


def _records(cost):
    return [(w.name, tuple(w.shape), str(w.dtype).replace("torch.", ""),
             w.direction, w.bytes, w.physical) for w in cost.wires]


def _jrecords(cost):
    return [(w.name, tuple(w.shape), jnp.dtype(w.dtype).name, w.direction,
             w.bytes, w.physical) for w in cost.wires]


@pytest.mark.parametrize("wire", list(WIRES))
def test_wire_records_match_reference(setup, wire):
    js, ts = _sessions(setup, *WIRES[wire])
    assert _records(ts.decode_cost(1)) == _jrecords(js.decode_cost(1))
    assert _records(ts.prefill_cost(B, S)) == _jrecords(js.prefill_cost(B, S))
    assert ts.bytes_per_token() == js.bytes_per_token()
    q8 = wire != "dense"
    assert ts.bytes_per_token() == (233 if q8 else 900)
    if q8:
        assert _records(ts.decode_cost(1)) == [
            ("cut_act", (1, 1, 128), "float32", "up", 132, wire != "fake_q8"),
            ("logits", (1, 1, 97), "float32", "down", 101,
             wire != "fake_q8")]


def test_decode_cost_touches_neither_caches_nor_kernels(setup):
    _, ts = _sessions(setup, *WIRES["fused_entry"])
    ts.prefill(torch.from_numpy(setup[-1]))
    before = [c["0"]["k"].clone() for c in ts._sc[0]]
    pos = ts._sc[0][0]["0"]["pos"]
    ops.reset_launches()
    cost = ts.decode_cost(B)
    assert all(w.physical for w in cost.wires)
    assert ts._sc[0][0]["0"]["pos"] == pos
    assert all(torch.equal(b, c["0"]["k"]) for b, c in zip(before, ts._sc[0]))
    assert sum(ops.launch_counts().values()) == 0


def test_session_defaults_to_the_gpu_and_never_falls_back(setup):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    cfg_t, params_t = setup[2], setup[3]
    plan = ServePlan(arch=cfg_t, max_batch=B, max_len=MAX_LEN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeSession(plan, params_t)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeSession(plan, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--reduced", "--split"])


def test_fused_entry_requires_physical_wire(setup):
    cfg_t, params_t = setup[2], setup[3]
    with pytest.raises(ValueError, match="fused_entry"):
        ServeSession(ServePlan(arch=cfg_t, max_batch=B, max_len=MAX_LEN,
                               fused_entry=True), params_t, device="cpu")


def test_wire_grammar_and_accounting():
    assert parse_wire("") == () and parse_wire(None) == ()
    (t,) = parse_wire("quantize_int8:physical")
    assert t.physical and not parse_wire("quantize_int8")[0].physical
    (noise,) = parse_wire("dp_noise:0.1")
    assert noise.name == "dp_noise" and not (noise.physical or noise.handoff)
    (probe,) = parse_wire("leakage_probe")
    assert probe.probe and not probe.physical
    with pytest.raises(ValueError, match="unknown"):
        parse_wire("gzip")
    # a physical transform whose byte claim drifts from its payload
    liar = WireTransform("liar", apply=lambda t, n, d: twc.pack_int8(t),
                         bytes_fn=lambda shape, dtype, nbytes: 1,
                         physical=True)
    with pytest.raises(WireAccountingError, match="drifted"):
        record(WireTape(WireStack([liar])), "cut_act", torch.ones(2, 3), "up")


def test_serve_cli_on_cpu(capsys):
    tlaunch.main(["--reduced", "--split", "--cut", "1", "--wire",
                  "quantize_int8:physical", "--fused-entry", "--batch", "2",
                  "--prompt-len", "7", "--gen", "4", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["wire_bytes_per_token"] == 128 + 4 + 256 + 4
    assert summary["device"] == "cpu" and summary["fused_entry"]
    assert len(summary["sample_tokens"]) == 4


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_reference():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert len(_port_files()) > 20
    assert not bad, bad
