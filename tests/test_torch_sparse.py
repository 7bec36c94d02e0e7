"""The port's ``sparse`` module against ``paddle_tpu.sparse`` on the same
numpy inputs: SelectedRows, the merge of duplicate rows, the row-wise
gradient of a lookup and the three row-wise updates, on rows with
duplicates, padding (row ``height``) and rows past the table.

Tolerance: rows and the merge's layout exactly; summed values and
updates within rtol 1e-6, atol 1e-7 (f32 sums of the same numbers; both
packages add a row's duplicates in their input order, so they agree to
the bit here, and the tolerance leaves room for a reordering only).

The JAX package's ``apply_adagrad`` and ``apply_adam_lazy`` write the
moments with ``.at[clipped].set`` for every merged slot, so a padding slot
clipped to row ``height - 1`` writes that row's old moment beside its new
one, and which write wins is not defined (on the CPU the old one does).
The port writes only the valid slots. The parity tests use inputs where
no slot touches row ``height - 1``; ``test_the_reference_moment_defect``
shows the difference against a float64 reference of the documented
semantics."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu import sparse as jsp
from paddle_tpu_torch import sparse as tsp

RTOL, ATOL = 1e-6, 1e-7
H = 12


def _sr(rows, vals, height=H):
    return (jsp.SelectedRows(jnp.asarray(rows), jnp.asarray(vals), height),
            tsp.SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals), height))


def _case(seed, n=24, d=4, hit_last=False):
    """Rows with duplicates, a row equal to ``height`` and rows past it;
    row ``height - 1`` only when ``hit_last``."""
    rng = np.random.RandomState(seed)
    top = H if hit_last else H - 1
    rows = rng.randint(0, top, n).astype(np.int32)
    rows[:4] = rows[4:8]                    # duplicates, for sure
    rows[8], rows[9], rows[10] = H, H + 3, 5 * H  # padding and past the table
    vals = rng.randn(n, d).astype(np.float32)
    return rows, vals


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("seed", [0, 1])
def test_to_dense_matches_jax(seed):
    rows, vals = _case(seed)
    rows[11], rows[12] = -1, -H  # counted from the end, as .at[] counts them
    j, t = _sr(rows, vals)
    _close(t.to_dense(), j.to_dense(), "to_dense")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_selected_rows_matches_jax(seed):
    rows, vals = _case(seed, hit_last=True)
    j, t = _sr(rows, vals)
    jm, tm = jsp.merge_selected_rows(j), tsp.merge_selected_rows(t)
    assert tm.rows.dtype == torch.int32 and tm.height == H
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    _close(tm.values, jm.values, "merged values")
    # rows ascending, the left-over slots padding rows of zeros at the end
    distinct = len(np.unique(rows))
    assert (np.diff(tm.rows.numpy()[:distinct]) > 0).all()
    assert (tm.rows.numpy()[distinct:] == H).all()
    assert not tm.values[distinct:].any()
    _close(tm.to_dense(), t.to_dense(), "merge keeps the dense sum")


def test_lookup_rowwise_grad_matches_jax_and_the_dense_grad():
    rng = np.random.RandomState(3)
    ids = rng.randint(0, H, (5, 3)).astype(np.int32)
    g = rng.randn(5, 3, 4).astype(np.float32)
    j = jsp.lookup_rowwise_grad(jnp.asarray(ids), jnp.asarray(g), H)
    t = tsp.lookup_rowwise_grad(torch.from_numpy(ids), torch.from_numpy(g), H)
    np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
    _close(t.values, j.values, "values")
    table = torch.zeros(H, 4, requires_grad=True)
    (table[torch.from_numpy(ids).long()] * torch.from_numpy(g)).sum().backward()
    _close(t.to_dense(), table.grad.numpy(), "dense grad of the lookup")


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_sgd_matches_jax(seed):
    rows, vals = _case(seed, hit_last=True)
    table = np.random.RandomState(9).randn(H, 4).astype(np.float32)
    j, t = _sr(rows, vals)
    want = jsp.apply_sgd(jnp.asarray(table), j, 0.05)
    got = tsp.apply_sgd(torch.from_numpy(table), t, 0.05)
    _close(got, want, "table")


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_adagrad_matches_jax(seed):
    rows, vals = _case(seed)
    rng = np.random.RandomState(10)
    table = rng.randn(H, 4).astype(np.float32)
    moment = rng.rand(H, 4).astype(np.float32)
    j, t = _sr(rows, vals)
    jt, jm = jsp.apply_adagrad(jnp.asarray(table), jnp.asarray(moment), j, 0.1)
    table_t, moment_t = torch.from_numpy(table), torch.from_numpy(moment)
    tt, tm = tsp.apply_adagrad(table_t, moment_t, t, 0.1)
    _close(tt, jt, "table")
    _close(tm, jm, "moment")
    # functional: the inputs keep their values
    assert np.array_equal(table_t.numpy(), table) and np.array_equal(moment_t.numpy(), moment)


@pytest.mark.parametrize("t_step", [0, 4])
def test_apply_adam_lazy_matches_jax(t_step):
    rows, vals = _case(7)
    rng = np.random.RandomState(11)
    table = rng.randn(H, 4).astype(np.float32)
    m1 = (0.1 * rng.randn(H, 4)).astype(np.float32)
    m2 = (0.01 * rng.rand(H, 4)).astype(np.float32)
    j, t = _sr(rows, vals)
    want = jsp.apply_adam_lazy(jnp.asarray(table), jnp.asarray(m1), jnp.asarray(m2), j,
                               0.01, t_step)
    got = tsp.apply_adam_lazy(torch.from_numpy(table), torch.from_numpy(m1),
                              torch.from_numpy(m2), t, 0.01, torch.tensor(t_step))
    for name, g, w in zip(("table", "m1", "m2"), got, want):
        _close(g, w, name)
    # rows the batch did not touch keep their moments bit for bit (lazy mode)
    untouched = np.setdiff1d(np.arange(H), rows)
    assert untouched.size
    np.testing.assert_array_equal(got[1].numpy()[untouched], m1[untouched])


def _adagrad_reference(table, moment, rows, vals, lr, eps=1e-6):
    """The documented semantics in float64: duplicates summed, then for
    each row in [0, height) ``m += g²``, ``p −= lr·g / (√m + eps)``."""
    table, moment = table.astype(np.float64), moment.astype(np.float64)
    g = np.zeros_like(table)
    for r, v in zip(rows, vals):
        if 0 <= r < table.shape[0]:
            g[r] += v
    touched = np.zeros(table.shape[0], bool)
    touched[[r for r in rows if 0 <= r < table.shape[0]]] = True
    m = moment + np.where(touched[:, None], g * g, 0.0)
    p = table - np.where(touched[:, None], lr * g / (np.sqrt(m) + eps), 0.0)
    return p, m


def test_the_reference_moment_defect():
    """ids [4, 4, 1] in a 5-row table, unit grads: row 4's merged grad is 2,
    so its moment must become 4 and the row move by about −lr. The JAX
    package moves the row but leaves its moment at 0 (the merge's padding
    slot, clipped to row 4, writes the old moment back); the port writes
    4, as the float64 reference does."""
    table, moment = np.zeros((5, 2), np.float32), np.zeros((5, 2), np.float32)
    rows, vals = np.array([4, 4, 1], np.int32), np.ones((3, 2), np.float32)
    j, t = _sr(rows, vals, height=5)
    want_p, want_m = _adagrad_reference(table, moment, rows, vals, 0.1)
    got_p, got_m = tsp.apply_adagrad(torch.from_numpy(table), torch.from_numpy(moment), t, 0.1)
    np.testing.assert_allclose(got_m.numpy(), want_m, rtol=1e-7)
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=1e-6)
    assert got_m[4].tolist() == [4.0, 4.0]
    jp, jm = jsp.apply_adagrad(jnp.asarray(table), jnp.asarray(moment), j, 0.1)
    np.testing.assert_allclose(np.asarray(jp), want_p, rtol=1e-6)  # the table is right
    assert np.asarray(jm)[4].tolist() != want_m[4].tolist()       # its moment is not
    # the same batch one row lower touches no padding row: both agree
    rows3 = np.array([3, 3, 1], np.int32)
    j3, t3 = _sr(rows3, vals, height=5)
    _, jm3 = jsp.apply_adagrad(jnp.asarray(table), jnp.asarray(moment), j3, 0.1)
    _, tm3 = tsp.apply_adagrad(torch.from_numpy(table), torch.from_numpy(moment), t3, 0.1)
    np.testing.assert_array_equal(tm3.numpy(), np.asarray(jm3))
    assert tm3[3].tolist() == [4.0, 4.0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adagrad_and_lazy_adam_hold_the_documented_semantics(seed):
    """With row height − 1 touched too, where the JAX result is not
    defined: the port against the float64 reference."""
    rows, vals = _case(seed, hit_last=True)
    rows[12] = H - 1
    rng = np.random.RandomState(seed + 20)
    table, moment = rng.randn(H, 4).astype(np.float32), rng.rand(H, 4).astype(np.float32)
    _, t = _sr(rows, vals)
    want_p, want_m = _adagrad_reference(table, moment, rows, vals, 0.1)
    got_p, got_m = tsp.apply_adagrad(torch.from_numpy(table), torch.from_numpy(moment), t, 0.1)
    np.testing.assert_allclose(got_m.numpy(), want_m, rtol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=1e-5, atol=1e-6)
    # lazy Adam: exactly the touched rows move their moments
    zeros = torch.zeros(H, 4)
    _, m1, m2 = tsp.apply_adam_lazy(torch.from_numpy(table), zeros, zeros, t, 0.01, 0)
    touched = np.zeros(H, bool)
    touched[rows[(rows >= 0) & (rows < H)]] = True
    assert (m2.numpy()[touched] > 0).all() and not m2.numpy()[~touched].any()


def test_a_negative_row_changes_nothing():
    """A row outside [0, height) is dropped by every update (the JAX
    package clips a negative row into row 0)."""
    table = torch.arange(10.0).reshape(5, 2)
    sr = tsp.SelectedRows(torch.tensor([-1, 7], dtype=torch.int32), torch.ones(2, 2), 5)
    assert torch.equal(tsp.apply_sgd(table, sr, 0.1), table)
    p, m = tsp.apply_adagrad(table, torch.zeros(5, 2), sr, 0.1)
    assert torch.equal(p, table) and not m.any()


def test_sharded_lookup_without_its_axis_is_a_plain_lookup():
    """On a mesh without the ``ep`` axis the lookup is ``table[ids]`` (the
    sharded path runs on gloo worlds: tests/test_torch_mesh_sharding.py)."""
    class _Mesh:
        axis_names, shape = ("dp",), {"dp": 4}

    table = torch.arange(12.0).reshape(6, 2)
    ids = torch.tensor([[5, 0], [2, 2]])
    assert torch.equal(tsp.sharded_embedding_lookup(table, ids, _Mesh()), table[ids])
