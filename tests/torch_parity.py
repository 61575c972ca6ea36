"""Holding the port's Engine to the JAX engine block by block on the CPU,
shared by the port's parity tests: both engines from the same params, and
each of the port's blocks started from the JAX engine's state (the AGC's
and the squelch's decisions can sit on their thresholds by construction,
ROADMAP Queue 3)."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

import ka9q_radio_tpu_torch.runtime as trt

# demodulator readouts compared at looser bounds elsewhere (the RDS
# baseband, the PLL's phase and offset: tests/test_torch_demods.py)
LOOSE = ("rds_baseband", "cphase", "foffset")


def tree_np(tree):
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    return tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)


def assert_same_tree(got, want, rtol=0.0, path=""):
    """Keys, dtypes and shapes equal; values equal (floats within rtol
    where it is given)."""
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            assert_same_tree(got[k], want[k], rtol, f"{path}/{k}")
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{k}"
        if rtol == 0.0 or w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=f"{path}/{k}")


def assert_outputs_close(to, jo, rtol: float = 2e-4, audio_rtol: float = 5e-4, where=""):
    """Every group's audio within audio_rtol of its peak, its info floats
    within rtol of their largest value, flags and counters exact; the
    front end's per-input IF power within 1e-5."""
    for name, j in jo.items():
        if name == "_frontend":
            np.testing.assert_allclose(to[name]["if_power"].numpy(), j["if_power"], rtol=1e-5)
            continue
        ja, ta = j["audio"], to[name]["audio"].numpy()
        assert ta.shape == ja.shape, (where, name)
        if ja.size:
            assert np.abs(ta - ja).max() <= audio_rtol * max(np.abs(ja).max(), 1e-30), (where, name)
        ji, ti = j["info"], to[name]["info"]
        assert sorted(ti) == sorted(ji), (where, name)
        for k, w in ji.items():
            g = ti[k].numpy()
            if w.dtype.kind in "biu":
                np.testing.assert_array_equal(g, w, err_msg=f"{where} {name}/{k}")
            elif k not in LOOSE:
                fin = np.isfinite(w)
                assert np.abs(g[fin] - w[fin]).max(initial=0) <= rtol * max(
                    np.abs(w[fin]).max(initial=0), 1e-30), (where, name, k)


def step_against_jax(je, te, blocks, skip: int = 2):
    """blocks (numpy, [n, L] or [n, B, L]) through both engines from the JAX
    engine's params, each port block from the JAX engine's state; outputs
    compared from block `skip` on (the master's turn-on before it).
    Returns the last (port outputs, JAX outputs)."""
    jp, js = je.init_params(), je.init_state()
    tp = trt.params_from_jax(jax.device_get(jp), device="cpu")
    assert_same_tree(tree_np(te.init_params()), jax.device_get(jp))
    step = jax.jit(je.step)
    for b, x in enumerate(blocks):
        ts = trt.state_from_jax(jax.device_get(js), device="cpu")
        js, jo = step(js, jp, jnp.asarray(x))
        ts, to = te.step(ts, tp, torch.from_numpy(np.ascontiguousarray(x)))
        jo = jax.device_get(jo)
        if b >= skip:
            assert_outputs_close(to, jo, where=f"block {b}")
    return to, jo
