"""The port's int8 block-scaled gradient sync against the JAX package's
``parallel/mesh.py`` ``int8_allreduce`` / ``int8_reduce_scatter``, on
the CPU.

The JAX side runs inside ``shard_map`` on the first N devices of the
8-device CPU mesh ``conftest.py`` forces; the port side runs kernel J's
plain versions, first as N thread ranks of one process
(``run_thread_ranks``) and then through a real gloo group of N processes
(``test_torch_ranks.py``).  Every
comparison is bit for bit (NaN where NaN): the same shared scale, the
same IEEE division and round-half-to-even, and an exact sum of small
integers leave nothing to round differently.

One property of the reference is not copied: XLA:CPU's cross-device max
drops NaN (``pmax`` of a NaN and a 3 is 3; of NaNs only, ``-inf``), so
on this mesh the JAX sync poisons a block holding a NaN only when every
device's copy of it is NaN.  Its own rule (``mesh.py:520-527``) poisons
any non-finite block, and so does the port (a non-finite absmax becomes
``+inf`` before the max); ``test_a_nan_on_one_rank_poisons_its_block``
holds the port to the rule and to JAX everywhere else.

The reference is the JAX function as its trainer runs it: inside a
jitted step, where XLA's algebraic simplifier folds ``scale = max(absmax,
1e-30) / 127`` into a multiply by ``float32(1/127)``, which moves ~4.5%
of the scales by one ulp from the division as written (and, where an
element sits on a rounding edge, its quantum).  The port multiplies by
the same reciprocal, and the JAX side of the bit-equality tests is
compiled with XLA's default passes.
``test_jax_without_the_fold_differs_only_by_the_divided_scale`` holds
the port to JAX compiled with that pass off: a numpy model of the sync
reproduces each side bit for bit with its own scale, and the two differ
only where that scale moved.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from active_learning_tpu.parallel import mesh as jax_mesh

from active_learning_tpu_torch.ops import int8_sync as j
from active_learning_tpu_torch.parallel import mesh as mesh_lib

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_ranks import run_ranks  # noqa: E402

FORMS = ("allgather", "reduce_scatter")


def _leaves(n: int, seed: int, nan_everywhere: bool = True):
    """Per-rank leaves ``[n, *shape]``: lengths off the 256 grid (1, 255,
    257, 256·n + 3, a 3-d leaf), an all-zero leaf, magnitudes from 1e-3
    to 50, a bf16 leaf, an int32 leaf; an inf on rank n-1 in leaf 1 and
    a NaN in leaf 0 (on every rank, or with ``nan_everywhere=False`` on
    rank 0 only)."""
    rng = np.random.default_rng(seed)
    shapes = [(3, 5, 7), (300,), (256,), (1,), (255,), (257,),
              (256 * n + 3,), (40, 9)]
    out = []
    for i, s in enumerate(shapes):
        scale = (1e-3, 1.0, 0.0, 50.0, 0.3, 2.0, 1e-2, 5.0)[i]
        out.append((rng.normal(size=(n,) + s) * scale).astype(np.float32))
    if nan_everywhere:
        out[0][:, 0, 0, 3] = np.nan
    else:
        out[0][0, 0, 0, 3] = np.nan
    out[1][n - 1, 260] = np.inf
    # The bf16 leaf: values bf16 can hold, so both packages start equal.
    out[7] = np.asarray(jnp.asarray(out[7]).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    out.append(rng.integers(-1000, 1000, size=(n, 7)).astype(np.int32))
    return out


def _jax_sync(leaves, n: int, form: str, algsimp: bool = True):
    """Each rank's synced leaves, ``[n, *shape]`` per leaf, as numpy
    (``algsimp``: compiled with XLA's algebraic simplifier, as the JAX
    package's jitted trainer runs it; off, the division by 127 stays a
    division, as op-by-op execution computes it)."""
    mesh = jax_mesh.make_mesh(n)
    xs = [jnp.asarray(x).astype(jnp.bfloat16) if i == 7 else jnp.asarray(x)
          for i, x in enumerate(leaves)]

    def body(*a):
        tree = [v[0] for v in a]
        out = (jax_mesh.int8_allreduce(tree, "data") if form == "allgather"
               else jax_mesh.int8_reduce_scatter(tree, n, "data"))
        return tuple(v[None] for v in out)

    f = jax.jit(shard_map(body, mesh=mesh,
                          in_specs=tuple(P("data") for _ in xs),
                          out_specs=tuple(P("data") for _ in xs),
                          check_rep=False))
    # With the simplifier off, the division by 127 stays a division (see
    # the module docstring).
    compiled = f.lower(*xs).compile(compiler_options=(
        None if algsimp else {"xla_disable_hlo_passes": "algsimp"}))
    return [np.asarray(jnp.asarray(o).astype(jnp.float32))
            if o.dtype == jnp.bfloat16 else np.asarray(o)
            for o in compiled(*xs)]


def _per_rank(leaves, n):
    return [[torch.from_numpy(x[r].copy()).to(torch.bfloat16) if i == 7
             else torch.from_numpy(x[r].copy())
             for i, x in enumerate(leaves)] for r in range(n)]


def _as_numpy(per_rank_out):
    n = len(per_rank_out)
    return [np.stack([per_rank_out[r][i].to(torch.float32).numpy()
                      if per_rank_out[r][i].is_floating_point()
                      else per_rank_out[r][i].numpy() for r in range(n)])
            for i in range(len(per_rank_out[0]))]


def _thread_sync(per_rank, form):
    """Each of N thread ranks runs the sync on its own leaves."""
    fn = (mesh_lib.int8_allreduce if form == "allgather"
          else mesh_lib.int8_reduce_scatter)
    return mesh_lib.run_thread_ranks(lambda m: fn(per_rank[m.rank], m),
                                     len(per_rank), "cpu", timeout_s=60)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_stacked_sync_is_bit_equal_to_jax(n, form):
    """Every leaf on every rank, bit for bit: tails, the zero leaf, the
    bf16 leaf (synced in float32, rounded back), the inf block and the
    all-rank NaN block (NaN everywhere), the int32 leaf summed
    exactly."""
    leaves = _leaves(n, seed=n)
    ref = _jax_sync(leaves, n, form)
    got = _as_numpy(_thread_sync(_per_rank(leaves, n), form))
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    assert np.isnan(got[0]).all()               # the NaN's block (105)
    assert np.isnan(got[1][:, 256:]).all()      # the inf's block
    assert np.isfinite(got[1][:, :256]).all()
    np.testing.assert_array_equal(got[8][0], leaves[8].sum(0))
    assert got[7].dtype == np.float32


@pytest.mark.parametrize("form", FORMS)
def test_a_nan_on_one_rank_poisons_its_block(form):
    """NaN on rank 0 only: the port poisons the NaN's block on every
    rank (the JAX package's rule); XLA:CPU's pmax drops the NaN, so JAX
    leaves that one block finite here.  Every other block is bit-equal
    to JAX."""
    n = 2
    leaves = _leaves(n, seed=11, nan_everywhere=False)
    ref = _jax_sync(leaves, n, form)
    got = _as_numpy(_thread_sync(_per_rank(leaves, n), form))
    assert np.isnan(got[0]).all()           # leaf 0 is one block
    assert np.isfinite(ref[0]).all()        # the reference's quirk
    for i in range(1, len(got)):
        np.testing.assert_array_equal(got[i], ref[i], err_msg=f"leaf {i}")


@pytest.mark.parametrize("form", FORMS)
def test_error_is_within_the_stated_bound(form):
    """Against the float64 sum: at most ``n · scale / 2`` per element
    (``+ scale2 / 2`` for the reduce-scatter form's re-quantization),
    ``scale`` the shared block absmax over 127."""
    n = 4
    rng = np.random.default_rng(5)
    xs = [(rng.normal(size=(n, 4 * 256 * n + 19)) *
           rng.uniform(0.01, 10, size=(n, 1))).astype(np.float32)]
    got = _as_numpy(_thread_sync(_per_rank(xs, n), form))[0][0]
    exact = xs[0].astype(np.float64).sum(0)
    m = xs[0].shape[1]
    pad = -m % (256 * (n if form == "reduce_scatter" else 1))
    padded = np.pad(xs[0], ((0, 0), (0, pad))).reshape(n, -1, 256)
    scale = np.abs(padded).max(axis=(0, 2)).astype(np.float64) / 127
    bound = np.repeat(n * scale / 2, 256)[:m]
    if form == "reduce_scatter":
        # scale2 from the result's block max (within scale2/2 of the
        # re-quantized block's), with 1% to spare.
        s2 = np.abs(np.pad(got, (0, pad)).reshape(-1, 256)).max(1) / 127 \
            * 1.01
        bound = bound + np.repeat(s2 / 2, 256)[:m]
    err = np.abs(got - exact)
    assert (err <= bound * (1 + 1e-4) + 1e-30).all(), \
        float((err / bound).max())


def _model_sync(leaves, n: int, form: str, fold: bool):
    """A numpy model of the JAX sync over float32 leaves ``[n, *shape]``:
    ``scale = max(absmax, 1e-30) / 127``, or with ``fold`` ``* float32(1 /
    127)``, as XLA's simplifier rewrites it.  Returns each leaf's result
    (the same on every rank) and its per-block details: the scale, the
    second scale (reduce-scatter), the ranks' int8 payloads and ``x /
    scale`` before rounding."""
    def scale_of(a):
        a = np.maximum(a, np.float32(1e-30))
        return a * np.float32(1.0 / 127.0) if fold else a / np.float32(127.0)

    outs, info = [], []
    for x in leaves:
        flat = x.reshape(n, -1)
        m = flat.shape[1]
        pad = -m % (256 * (n if form == "reduce_scatter" else 1))
        blocks = np.pad(flat, ((0, 0), (0, pad))).reshape(n, -1, 256)
        with np.errstate(invalid="ignore", divide="ignore"):
            absmax = np.abs(blocks).max(axis=2).max(axis=0)
            bad = ~np.isfinite(absmax)
            scale = scale_of(absmax)
            ratio = blocks / scale[None, :, None]
            q = np.where(bad[None, :, None], 0,
                         np.clip(np.rint(ratio), -127, 127)).astype(np.int8)
            total = q.astype(np.float32).sum(0)
            scale2 = None
            if form == "allgather":
                res = total * scale[:, None]
            else:
                reduced = total * scale[:, None]
                scale2 = scale_of(np.abs(reduced).max(1))
                q2 = np.clip(np.rint(reduced / scale2[:, None]), -127, 127)
                res = q2.astype(np.int8).astype(np.float32) * scale2[:, None]
        res = np.where(bad[:, None], np.float32(np.nan), res)
        outs.append(np.broadcast_to(res.reshape(-1)[:m].reshape(x.shape[1:]),
                                    x.shape))
        info.append({"bad": bad, "scale": scale, "scale2": scale2, "q": q,
                     "ratio": ratio, "pad": pad})
    return outs, info


def _edge_block(n: int, rng):
    """One block on every rank whose scale the fold moves, holding a
    value on a rounding edge: ``x / scale`` rounds one way with the
    divided scale and the other with the folded one."""
    c = np.float32(1.0 / 127.0)
    while True:
        a = np.float32(rng.uniform(0.5, 2.0))
        s_div, s_mul = a / np.float32(127.0), a * c
        if s_div == s_mul:
            continue
        for k in range(3, 120):
            e = np.float32((k + 0.5) * s_div)
            for cand in (e, np.nextafter(e, np.float32(0)),
                         np.nextafter(e, np.float32(1e9))):
                if np.rint(cand / s_div) != np.rint(cand / s_mul):
                    block = (rng.normal(size=(n, 256)) * 1e-3).astype(
                        np.float32)
                    block[:, 0], block[:, 9] = a, cand
                    return block


@pytest.mark.parametrize("form", FORMS)
def test_jax_without_the_fold_differs_only_by_the_divided_scale(form):
    """JAX compiled with the algebraic simplifier off keeps ``/127`` a
    division; the port multiplies by ``float32(1/127)``, as the default
    compile folds it.  A numpy model of the sync with either scale is
    each side bit for bit, so nothing else differs.  The two differ only
    in blocks whose scale (reduce-scatter: or second scale) moved, each
    by one ulp: there by the ulp's product and one quantum per rank
    whose ``x / scale`` sits on a rounding edge (reduce-scatter: and one
    quantum of the second scale)."""
    n = 4
    rng = np.random.default_rng(31)
    leaves = [(rng.normal(size=(n, 5000)) * 0.1).astype(np.float32),
              (rng.normal(size=(n, 129, 257)) * 3.0).astype(np.float32),
              np.tile(_edge_block(n, rng), (1, n))]
    leaves[0][:, 17] = np.nan
    ref = _jax_sync(leaves, n, form, algsimp=False)
    got = _as_numpy(_thread_sync(_per_rank(leaves, n), form))
    div, div_info = _model_sync(leaves, n, form, fold=False)
    mul, mul_info = _model_sync(leaves, n, form, fold=True)
    moved_blocks = edge_flips = blocks = 0
    for i in range(len(leaves)):
        np.testing.assert_array_equal(got[i], mul[i], err_msg=f"leaf {i}")
        np.testing.assert_array_equal(ref[i], div[i], err_msg=f"leaf {i}")
        d, m = div_info[i], mul_info[i]
        ok = ~d["bad"]
        moved = (d["scale"] != m["scale"]) & ok
        assert (np.abs(d["scale"][moved].view(np.int32)
                       - m["scale"][moved].view(np.int32)) == 1).all()
        moved2 = np.zeros_like(moved)
        if form == "reduce_scatter":
            moved2 = (d["scale2"] != m["scale2"]) & ok & ~moved
            assert (np.abs(d["scale2"][moved2].view(np.int32)
                           - m["scale2"][moved2].view(np.int32)) == 1).all()
        flips = np.abs(d["q"].astype(np.int32) - m["q"])
        assert flips.max() <= 1
        frac = np.abs(d["ratio"]) % 1.0
        assert (np.abs(frac[flips == 1] - 0.5) < 1e-5).all()
        assert not flips[:, ~moved].any()
        # Per element, against the JAX result.
        a = np.pad(got[i][0].reshape(-1), (0, d["pad"])).reshape(-1, 256)
        b = np.pad(ref[i][0].reshape(-1), (0, d["pad"])).reshape(-1, 256)
        same = ok & ~moved & ~moved2
        np.testing.assert_array_equal(a[same], b[same])
        bound = flips.sum(0) * d["scale"][:, None] \
            + 3 * np.spacing(np.abs(b))
        if form == "reduce_scatter":
            bound = bound + np.maximum(d["scale2"], m["scale2"])[:, None]
        assert (np.abs(a - b)[ok] <= bound[ok]).all(), i
        moved_blocks += int(moved.sum())
        edge_flips += int(flips.sum())
        blocks += int(ok.sum())
    # The fold moves a few percent of the scales; the planted edge flips.
    assert 0 < moved_blocks < 0.1 * blocks and edge_flips >= n


def test_thread_ranks_meet_without_lost_updates():
    """Sixteen thread ranks, a switch interval of a microsecond, 200
    rounds of each collective: every rank sees every peer's tensor of
    this round, never a stale or a later one."""
    n, rounds = 16, 200

    def body(m):
        seen = []
        for k in range(rounds):
            mine = torch.tensor([m.rank * 1000 + k], dtype=torch.int64)
            total = m.all_reduce(mine.clone())
            top = m.all_reduce(mine.clone(), "max")
            every = m.all_gather(mine)
            swap = m.all_to_all(torch.arange(n) + 100 * m.rank + k)
            seen.append((int(total), int(top), every[:, 0].tolist(),
                         swap.tolist()))
        return seen

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs = mesh_lib.run_thread_ranks(body, n, "cpu", timeout_s=60)
    finally:
        sys.setswitchinterval(old)
    for r, seen in enumerate(outs):
        for k, (total, top, every, swap) in enumerate(seen):
            assert total == 1000 * n * (n - 1) // 2 + n * k
            assert top == 1000 * (n - 1) + k
            assert every == [1000 * p + k for p in range(n)]
            assert swap == [r + 100 * p + k for p in range(n)]


def test_a_thread_rank_that_raises_fails_the_run():
    def body(m):
        if m.rank == 1:
            raise RuntimeError("rank 1 failed")
        return m.all_reduce(torch.ones(1))

    with pytest.raises(RuntimeError, match="rank 1 failed"):
        mesh_lib.run_thread_ranks(body, 3, "cpu", timeout_s=60)


@pytest.mark.parametrize("n", [2, 4])
def test_sync_through_a_gloo_group_is_bit_equal_to_jax(n, tmp_path):
    """N processes joined over gloo run ``int8_allreduce`` and
    ``int8_reduce_scatter`` on their own leaves: every rank's result is
    JAX's bit for bit, and the f32 sync is the float32 sum."""
    leaves = _leaves(n, seed=20 + n)
    per_rank = _per_rank(leaves, n)
    outs = run_ranks("int8_sync", n, tmp_path, {"per_rank": per_rank})
    for form in FORMS:
        ref = _jax_sync(leaves, n, form)
        got = _as_numpy([o[form] for o in outs])
        for i, (a, b) in enumerate(zip(got, ref)):
            np.testing.assert_array_equal(a, b, err_msg=f"{form} {i}")
    f32 = _as_numpy([o["f32"] for o in outs])
    np.testing.assert_array_equal(f32[8][0], leaves[8].sum(0))
    for r in range(1, n):
        for a in f32:
            np.testing.assert_array_equal(a[r], a[0])


# -- the rules: tests/test_pod_tier.py::TestWireResolution and
# test_backward.py::test_resolve_rule_off_on_single_device ---------------

def _port_mesh(n):
    return mesh_lib.Mesh(0, n, torch.device("cpu"),
                         "none" if n == 1 else "gloo")


def test_resolve_grad_allreduce_modes():
    for n in range(1, 9):
        jm = jax_mesh.make_mesh(n)
        for mode in ("f32", "int8", "int8_rs", "auto"):
            assert mesh_lib.resolve_grad_allreduce(mode, _port_mesh(n)) \
                == jax_mesh.resolve_grad_allreduce(mode, jm)
    one, full = _port_mesh(1), _port_mesh(8)
    for mode in ("int8", "int8_rs", "auto"):
        assert mesh_lib.resolve_grad_allreduce(mode, one) == "f32"
        assert mesh_lib.resolve_grad_allreduce(mode, full) == "int8"
    assert mesh_lib.resolve_grad_allreduce("f32", full) == "f32"
    with pytest.raises(ValueError):
        mesh_lib.resolve_grad_allreduce("int4", full)


def test_resolve_rule_off_on_single_device():
    one, full = _port_mesh(1), _port_mesh(8)
    assert mesh_lib.resolve_grad_allreduce("int8", one) == "f32"
    assert mesh_lib.resolve_grad_allreduce("int8", full) == "int8"
    assert mesh_lib.resolve_grad_allreduce("f32", full) == "f32"
    with pytest.raises(ValueError):
        mesh_lib.resolve_grad_allreduce("int4", full)


def test_resolve_int8_wire_crossover():
    for n in range(1, 9):
        for mode in ("int8", "int8_rs", "auto"):
            assert mesh_lib.resolve_int8_wire(mode, _port_mesh(n)) \
                == jax_mesh.resolve_int8_wire(mode, jax_mesh.make_mesh(n))
    assert mesh_lib.resolve_int8_wire("int8", _port_mesh(8)) == "allgather"
    assert mesh_lib.resolve_int8_wire("auto", _port_mesh(8)) == "allgather"
    assert mesh_lib.resolve_int8_wire("int8_rs", _port_mesh(2)) \
        == "reduce_scatter"
    # Above the crossover (the CPU mesh has 8 devices: port rule only).
    for n in (9, 16, 64):
        assert mesh_lib.resolve_int8_wire("int8", _port_mesh(n)) \
            == "reduce_scatter"
    assert mesh_lib.INT8_WIRE_CROSSOVER_NDEV \
        == jax_mesh.INT8_WIRE_CROSSOVER_NDEV
    assert mesh_lib.INT8_BLOCK == jax_mesh.INT8_BLOCK == j.BLOCK
    assert mesh_lib.GRAD_ALLREDUCE_MODES == jax_mesh.GRAD_ALLREDUCE_MODES
    assert mesh_lib.INT8_WIRE_FORMS == jax_mesh.INT8_WIRE_FORMS


def test_wire_model_table():
    n = 10 ** 6
    for ndev in (1, 2, 4, 8, 9, 16, 64, 256):
        for form in ("f32", "allgather", "reduce_scatter"):
            assert mesh_lib.wire_model_bytes(form, ndev, n) \
                == jax_mesh.wire_model_bytes(form, ndev, n)
    for ndev in (8, 9, 16, 64, 256):
        rs = mesh_lib.wire_model_bytes("reduce_scatter", ndev, n)
        assert rs < mesh_lib.wire_model_bytes("allgather", ndev, n)
        assert rs < mesh_lib.wire_model_bytes("f32", ndev, n)
    assert mesh_lib.wire_model_bytes("allgather", 9, n) \
        > mesh_lib.wire_model_bytes("f32", 9, n)
    with pytest.raises(ValueError):
        mesh_lib.wire_model_bytes("int4", 8, n)


# -- the layout and the wrappers ---------------------------------------------

def test_reduce_scatter_send_order_is_dest_leaf_block():
    """Leaf l's block k lands at ``dest · per_dest + C_l + k mod m_l``:
    the all_to_all send buffer ordered [dest][leaf][block]."""
    n = 2
    ts = [torch.zeros(600), torch.zeros(3), torch.zeros(1100)]
    lay = mesh_lib.sync_layout(ts, n, "reduce_scatter")
    # Blocks per leaf: 4, 2, 6 (each a multiple of n): m = 2, 1, 3.
    assert lay.num_blocks == 12 and lay.per_dest == 6
    want = [0, 1, 6, 7,  2, 8,  3, 4, 5, 9, 10, 11]
    assert lay.slot_of_block(torch.device("cpu")).tolist() == want


def test_layout_views_keep_the_leaf_strides():
    w = torch.randn(4, 3, 2, 2).contiguous(memory_format=torch.channels_last)
    ts = [w, torch.randn(5)]
    lay = mesh_lib.sync_layout(ts, 2, "allgather")
    back = lay.unpack(lay.pack(ts, torch.device("cpu")), ts)
    assert back[0].stride() == w.stride()
    assert torch.equal(back[0], w) and torch.equal(back[1], ts[1])


def test_wrappers_run_the_plain_version_on_the_cpu():
    x = torch.randn(4 * 256)
    before = (j.absmax_launches, j.quantize_launches, j.dequant_launches,
              j.requantize_launches)
    a = j.block_absmax(x)
    q, s = j.quantize(x, a)
    out = j.dequant_sum(q[None], s, a)
    q2, s2 = j.sum_requantize(q[None], s)
    assert (j.absmax_launches, j.quantize_launches, j.dequant_launches,
            j.requantize_launches) == before
    assert torch.equal(out, j.dequant_sum_reference(q[None], s, a))
    assert (q2.int() - q.int()).abs().max() <= 1 and s2.shape == s.shape
    with pytest.raises(ValueError, match="multiple"):
        j.block_absmax(torch.zeros(300))


def test_the_scale_is_the_folded_reciprocal_of_the_default_compile():
    """The plain version's block scale is JAX's ``max(absmax, 1e-30) /
    127`` as a default (jitted) compile computes it, bit for bit over
    absmax values across 12 decades, zero and the floor; the division as
    written differs from it by one ulp on a few percent of them."""
    rng = np.random.default_rng(7)
    a = np.concatenate([np.abs(rng.normal(size=4096))
                        * 10.0 ** rng.uniform(-8, 4, size=4096),
                        [0.0, 1e-35, 1e-30, 1.0, 127.0]]).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda v: jnp.maximum(v, jnp.float32(1e-30)) / 127.0)(a))
    _, scale = j.quantize_reference(torch.zeros(a.size * j.BLOCK),
                                    torch.from_numpy(a))
    np.testing.assert_array_equal(scale.numpy().view(np.int32),
                                  want.view(np.int32))
    divided = np.maximum(a, np.float32(1e-30)) / np.float32(127.0)
    moved = divided != want
    assert 0 < moved.sum() < 0.1 * a.size
    assert (np.abs(divided[moved].view(np.int32)
                   - want[moved].view(np.int32)) == 1).all()
