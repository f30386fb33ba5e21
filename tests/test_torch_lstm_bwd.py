"""Port vs JAX on CPU: K8 (`bilstm_pallas_trainable`) through its plain
route, against `jax.vjp` of the JAX package's XLA BiLSTM
(`stjep_tpu.ops.lstm.bilstm`), and the guard that keeps the inference
kernels out of autograd. Tolerance 1e-5: f32 on both sides, only the
summation order of the products differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stjep_tpu.ops.lstm import bilstm as jax_bilstm
from stjep_tpu.ops.lstm import bilstm_init as jax_bilstm_init
from stjep_tpu_torch import kernels
from stjep_tpu_torch.bridge import params_from_numpy
from stjep_tpu_torch.ops.lstm_pallas_bwd import (
    bilstm_fwd_save_plain,
    bilstm_pallas_trainable,
)

TOL = 1e-5
B, T, DIN, H = 3, 21, 8, 64


def _case(lengths):
    p = jax.tree_util.tree_map(np.asarray,
                               jax_bilstm_init(jax.random.PRNGKey(1), DIN, H))
    rng = np.random.RandomState(0)
    x = rng.randn(B, T, DIN).astype(np.float32)
    g = rng.randn(B, T, 2 * H).astype(np.float32)
    return p, x, g


@pytest.mark.parametrize("lengths", [[T, 9, 1], [T, T, T], None, [T, 0, 5]],
                         ids=["ragged", "full", "none", "empty_row"])
def test_trainable_bilstm_matches_jax_vjp(lengths):
    p, x, g = _case(lengths)
    lens_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    out, vjp = jax.vjp(lambda pf, pb, xx: jax_bilstm(pf, pb, xx, lengths=lens_j),
                       p["fwd"], p["bwd"], jnp.asarray(x))
    d_pf, d_pb, d_x = vjp(jnp.asarray(g))

    tp = params_from_numpy(p)
    for d in ("fwd", "bwd"):
        for t in tp[d].values():
            t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    lens_t = None if lengths is None else torch.tensor(lengths)
    o = bilstm_pallas_trainable(tp["fwd"], tp["bwd"], xt, lens_t)
    o.backward(torch.from_numpy(g))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), atol=TOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(d_x), atol=TOL, rtol=0)
    for d, ref in (("fwd", d_pf), ("bwd", d_pb)):
        for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
            np.testing.assert_allclose(tp[d][k].grad.numpy(), np.asarray(ref[k]),
                                       atol=TOL, rtol=TOL, err_msg=f"{d}/{k}")


def test_saved_streams_follow_the_jax_layout():
    """hs/cs hold the carries BEFORE each step, time-major; the reverse
    direction starts at T-1; gates are zero past a row's length."""
    p, x, _ = _case(None)
    tp = params_from_numpy(p)
    lens = torch.tensor([T, 9, 1])
    w = lambda k: (tp["fwd"][k], tp["bwd"][k])
    bias = tuple(a + b for a, b in zip(w("b_ih"), w("b_hh")))
    out, hs, cs, gates = bilstm_fwd_save_plain(w("w_ih"), w("w_hh"), bias,
                                               torch.from_numpy(x), lens)
    assert hs.shape == cs.shape == (2, T, B, H) and gates.shape == (2, T, B, 4 * H)
    assert torch.all(hs[0, 0] == 0) and torch.all(cs[0, 0] == 0)
    assert torch.all(hs[1, T - 1] == 0)
    # forward direction: the carry before step t is the output of step t-1
    torch.testing.assert_close(hs[0, 1:, 0], out[0, :-1, :H], rtol=0, atol=0)
    valid = torch.arange(T)[:, None] < lens[None, :]  # [T, B]
    assert torch.all(gates[:, ~valid] == 0)
    assert torch.all(gates[:, valid] != 0)


def test_refuse_grad_helper():
    """The guard of the inference kernels' CUDA routes, on CPU tensors."""
    w = torch.zeros(3, requires_grad=True)
    x = torch.zeros(3)
    with pytest.raises(RuntimeError, match="bilstm_pallas_trainable"):
        kernels.refuse_grad("bilstm_pallas", "bilstm_pallas_trainable", x, w)
    kernels.refuse_grad("bilstm_pallas", "bilstm_pallas_trainable", x, x)
    with torch.no_grad():
        kernels.refuse_grad("bilstm_pallas", "bilstm_pallas_trainable", x, w)
