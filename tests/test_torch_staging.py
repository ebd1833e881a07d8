"""The staging kernels (``shift_blocks``, ``pack_blocks``) and the grid's
row moves built on them.

On the CPU the wrappers in ``repro_torch.kernels.staging`` run their plain
versions (``kernels/ref.py``). Those are held bitwise against the
reference's Pallas kernels (``repro.kernels.ops``, interpret mode on the
CPU) at the reference test's N, m and dtypes, one rank's row at a time for
the per-rank forms. ``RankGrid.roll``, ``take``, ``dynamic_slice`` and
``ppermute``, which now dispatch to the wrappers, are held bitwise against
a copy of the indexing code they replaced (kept below), over every group
of axes, full and partial permutations, sliced operands, every dtype the
collectives carry, signed zeros, NaN payloads and zero-size operands. The
``cuda``-marked tests hold each CUDA kernel against its plain version on
the card, bitwise, and skip where there is no card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import mcoll, oracles, runtime
from repro_torch.core.comm import Communicator
from repro_torch.core.grid import RankGrid
from repro_torch.kernels import ref
from repro_torch.kernels import staging

N, P = 2, 4
WORLD = N * P
#: the reference test's (N, m) and dtypes (tests/test_kernels.py)
SHAPES = [(4, 8), (16, 32), (7, 5), (128, 16)]
DTYPES = ["float32", "bfloat16", "int32"]
#: every dtype a row move carries, bit for bit
ALL_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
              torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64,
              torch.uint16, torch.uint32, torch.uint64, torch.bool,
              torch.float8_e4m3fn, torch.complex64]


@pytest.fixture(scope="module")
def jops():
    """The reference kernels (interpret mode on the CPU); imported here so
    the ``cuda`` tests below also run on a machine without JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops
    return ops, jnp


def _blocks(R, n, m, dtype, seed):
    """``(R, n, m)`` numpy rows of ``dtype`` from a seed (values that every
    dtype holds exactly)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-100, 100, (R, n, m)).astype(np.float32)
    return x if dtype == "float32" else x.astype(np.int32) \
        if dtype == "int32" else x


def _torch(x, dtype):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _jax(jnp, x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else x.dtype)


def _as_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# the plain versions against the reference's Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_shift_blocks_matches_pallas(jops, n, m, dtype):
    """Rank r's rows rolled by its own shift, held against the reference
    kernel on rank r's (n, m) buffer, for every rank in turn."""
    ops, jnp = jops
    shifts = np.array([0, 1, n // 2, n - 1, 3 * n + 2, -1])
    x = _blocks(len(shifts), n, m, dtype, seed=n * 100 + m)
    got = _as_np(ref.shift_blocks(_torch(x, dtype), torch.from_numpy(shifts)))
    for r, s in enumerate(shifts):
        want = ops.shift_blocks(_jax(jnp, x[r], dtype), jnp.int32(s))
        np.testing.assert_array_equal(got[r],
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_blocks_matches_pallas(jops, n, m, dtype):
    """The flat form on one buffer, and the per-rank form with each rank's
    own index list, against the reference kernel rank by rank."""
    ops, jnp = jops
    rng = np.random.default_rng(n + m)
    R, K = 3, 5
    x = _blocks(R, n, m, dtype, seed=n + 7 * m)
    idx = rng.integers(0, n, (R, K))
    flat = _as_np(ref.pack_blocks(_torch(x[0], dtype),
                                  torch.from_numpy(idx[0])))
    want = ops.pack_blocks(_jax(jnp, x[0], dtype), jnp.asarray(idx[0],
                                                               jnp.int32))
    np.testing.assert_array_equal(flat, np.asarray(want, np.float32))
    got = _as_np(ref.pack_blocks(_torch(x, dtype), torch.from_numpy(idx)))
    for r in range(R):
        want = ops.pack_blocks(_jax(jnp, x[r], dtype),
                               jnp.asarray(idx[r], jnp.int32))
        np.testing.assert_array_equal(got[r], np.asarray(want, np.float32))


def test_pack_blocks_zero_rows_and_trailing_dims():
    """An index outside [0, N) gives a row of +0 bits; rows keep trailing
    dims; a -0.0 or NaN payload that is gathered comes through bitwise."""
    src = torch.full((4, 3, 2), -0.0)
    src[1] = float("nan")
    src[2, 0, 1] = torch.tensor(0x7FC00001, dtype=torch.int32).view(
        torch.float32)  # a NaN with a payload
    out = ref.pack_blocks(src, torch.tensor([2, -1, 0, 4, 1]))
    bits = out.view(torch.int32)
    assert torch.equal(bits[0], src[2].view(torch.int32))
    assert torch.equal(bits[2], src[0].view(torch.int32))
    assert torch.equal(bits[4], src[1].view(torch.int32))
    assert not bits[1].any() and not bits[3].any()
    per_rank = ref.pack_blocks(src[None].expand(2, -1, -1, -1),
                               torch.tensor([[3, -2], [9, 1]]))
    assert torch.equal(per_rank[0, 0].view(torch.int32),
                       src[3].view(torch.int32))
    assert not per_rank[0, 1].view(torch.int32).any()
    assert not per_rank[1, 0].view(torch.int32).any()


def test_plain_row_moves_take_any_layout():
    """Strided, transposed, expanded and one-element rows gather as plain
    indexing gathers them (the plain versions move rows as bytes)."""
    y = torch.arange(48.0).reshape(4, 3, 4)
    r = torch.arange(4)
    for x in (y[..., ::2], y.transpose(1, 2), y[:, :, :1], y[:, :1].expand(
            4, 3, 4), torch.arange(12.0).reshape(4, 3)[..., None].expand(
            4, 3, 5), torch.arange(12.0).reshape(4, 3),
            y.to(torch.uint64), y.bool()):
        K = x.shape[1]
        want = x[r[:, None], (torch.arange(K)[None] - r[:, None]) % K]
        _same_bits(ref.shift_blocks(x, r), want)
        idx = torch.stack([r % K, (r + 1) % K], 1)
        _same_bits(ref.pack_blocks(x, idx), x[r[:, None], idx])
        flat = torch.tensor([3, 1, 0, 0])
        _same_bits(ref.pack_blocks(x, flat), x[flat])


@pytest.mark.parametrize("shape,idx_shape", [
    ((0, 3), (4,)), ((5, 0), (4,)), ((5, 3), (0,)), ((2, 0, 3), (2, 4)),
    ((2, 5, 3), (2, 0)), ((0, 5), (0, 2))])
def test_zero_size_operands(shape, idx_shape):
    src = torch.zeros(shape)
    idx = torch.zeros(idx_shape, dtype=torch.long)
    out = staging.pack_blocks(src, idx)
    lead = len(idx_shape)
    assert tuple(out.shape) == tuple(idx_shape) + shape[lead:]
    assert not out.any()
    v = torch.zeros((3, 0, 2))
    assert tuple(staging.shift_blocks(v, torch.zeros(3, dtype=torch.long))
                 .shape) == (3, 0, 2)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="shift_blocks takes"):
        staging.shift_blocks(torch.zeros(4, 3), torch.zeros(3))
    with pytest.raises(ValueError, match="pack_blocks takes"):
        staging.pack_blocks(torch.zeros(4, 3), torch.zeros((3, 2)))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        staging.pack_blocks(torch.zeros(4, 3, device="meta"),
                            torch.zeros(2, dtype=torch.long, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        staging.shift_blocks(torch.zeros(4, 3),
                             torch.zeros(4, dtype=torch.long, device="meta"))


# ---------------------------------------------------------------------------
# the grid's row moves against the indexing code they replaced
# ---------------------------------------------------------------------------

_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def _old_signed(fn):
    def call(g, x, *args):
        dt = _SIGNED.get(x.dtype)
        return fn(g, x, *args) if dt is None else \
            fn(g, x.view(dt), *args).view(x.dtype)
    return call


def _old_groups(g, x, ax):
    rest = tuple(x.shape[1:])
    if ax == ("node", "local"):
        return x.reshape((1, g.world) + rest)
    v = x.reshape((g.n_nodes, g.n_local) + rest)
    return v if ax == ("local",) else v.transpose(0, 1)


def _old_ungroup(g, v, ax):
    if ax == ("node",):
        v = v.transpose(0, 1)
    return v.reshape((g.world,) + tuple(v.shape[2:]))


@_old_signed
def _old_ppermute(g, x, ax, pairs):
    v = _old_groups(g, x, ax)
    G = v.shape[1]
    src_of = [-1] * G
    for s, d in pairs:
        src_of[int(d)] = int(s)
    if all(s >= 0 for s in src_of):
        return _old_ungroup(g, v.index_select(1, torch.tensor(src_of)), ax)
    out = torch.zeros_like(v)
    dst = [d for d in range(G) if src_of[d] >= 0]
    out[:, dst] = v[:, [src_of[d] for d in dst]]
    return _old_ungroup(g, out, ax)


@_old_signed
def _old_take(g, x, idx):
    rows = torch.arange(g.world)
    return x[rows, idx] if idx.dim() == 1 else x[rows[:, None], idx]


def _old_roll(g, x, shift):
    K = x.shape[1]
    k = torch.arange(K)
    return _old_take(g, x, (k[None, :] - shift[:, None]) % K)


def _old_dynamic_slice(g, x, start, size):
    K = x.shape[1]
    s = start.clamp(0, K - size)
    return _old_take(g, x, s[:, None] + torch.arange(size)[None, :])


def _payload(dtype, shape, seed):
    """Random bits of ``dtype`` with -0.0 and NaN payloads among them."""
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=gen).bool()
    size = torch.empty((), dtype=dtype).element_size()
    raw = torch.randint(0, 256, tuple(shape) + (size,), generator=gen,
                        dtype=torch.uint8)
    x = raw.view(dtype).reshape(shape)
    if dtype in (torch.float16, torch.bfloat16, torch.float32,
                 torch.float64) and x.numel() > 2:
        flat = x.reshape(-1)
        flat[0] = -0.0
        flat[1] = float("nan")
    return x


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.numel() == 0:
        return
    assert torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


GROUPS = [("node",), ("local",), ("node", "local")]
#: member pairs per group size: a full rotation and a partial permutation
PAIRS = {2: [[(0, 1), (1, 0)], [(0, 1)]],
         4: [[(i, (i + 1) % 4) for i in range(4)], [(0, 2), (3, 1)]],
         8: [[(i, i ^ 3) for i in range(8)], [(0, 5), (2, 6), (7, 0)]]}


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=str)
def test_grid_row_moves_match_the_old_indexing(dtype):
    g = RankGrid(N, P, "cpu")
    r = torch.arange(WORLD)
    x = _payload(dtype, (WORLD, 6, 3, 2), seed=ALL_DTYPES.index(dtype))
    sliced = x[:, 1:4]  # a strided operand, as V[:, :send_cnt]
    for ax in GROUPS:
        G = {("node",): N, ("local",): P}.get(ax, WORLD)
        for pairs in PAIRS[G]:
            for op in (x, sliced):
                _same_bits(g.ppermute(op, ax, pairs),
                           _old_ppermute(g, op, ax, pairs))
    for op in (x, sliced):
        K = op.shape[1]
        for shift in (r, r // P, 3 - r, torch.full((WORLD,), 7)):
            _same_bits(g.roll(op, shift), _old_roll(g, op, shift))
        _same_bits(g.take(op, r % K), _old_take(g, op, r % K))
        idx = torch.stack([(r + k) % K for k in range(4)], 1)
        _same_bits(g.take(op, idx), _old_take(g, op, idx))
        for size in (0, 1, K):
            _same_bits(g.dynamic_slice(op, r - 2, size),
                       _old_dynamic_slice(g, op, r - 2, size))


@pytest.mark.parametrize("shape", [(WORLD, 0), (WORLD, 3, 0), (WORLD, 0, 4)])
def test_grid_row_moves_of_zero_size_operands(shape):
    g = RankGrid(N, P, "cpu")
    x = torch.zeros(shape)
    r = torch.arange(WORLD)
    for ax in GROUPS:
        assert g.ppermute(x, ax, [(0, 1)]).shape == x.shape
    assert g.roll(x, r).shape == x.shape
    if shape[1]:
        assert g.take(x, r % shape[1]).shape == (WORLD,) + shape[2:]
    assert g.dynamic_slice(x, r, 0).shape == (WORLD, 0) + shape[2:]


@pytest.mark.parametrize("bad", [-1, 6, 100])
def test_take_refuses_indices_outside_the_rows_on_the_cpu(bad):
    """Only ppermute's source map gives zero rows (-1 where no rank sends);
    a take index outside [0, K) is an error, in either form. A
    dynamic_slice start is clamped, so it never reaches one."""
    g = RankGrid(N, P, "cpu")
    x = _payload(torch.float32, (WORLD, 6, 2), seed=bad & 0xFF)
    r = torch.arange(WORLD)
    one = r % 6
    one[3] = bad
    with pytest.raises(IndexError, match="outside"):
        g.take(x, one)
    many = torch.stack([r % 6, r % 6], 1)
    many[5, 1] = bad
    with pytest.raises(IndexError, match="outside"):
        g.take(x, many)
    _same_bits(g.dynamic_slice(x, r * 0 + bad, 2),
               _old_dynamic_slice(g, x, r * 0 + bad, 2))


def test_ppermute_source_map_is_built_once_on_the_device():
    """A repeated round reuses its (world,) source map: built once per
    (axes, pairs), -1 where no rank sends, kept on the grid's device."""
    g = RankGrid(N, P, "cpu")
    x = torch.arange(WORLD * 2.0).reshape(WORLD, 2)
    g.ppermute(x, "node", [(0, 1)])
    m = g._src_map("node", [(0, 1)])
    assert m is g._src_map(("node",), ((0, 1),))
    assert m.tolist() == [-1, -1, -1, -1, 0, 1, 2, 3]
    assert g._src_map("local", [(1, 0), (2, 3)]).tolist() == \
        [1, -1, -1, 2, 5, -1, -1, 6]
    assert g._src_map(("node", "local"), [(7, 0)]).tolist() == \
        [7] + [-1] * 7
    assert len(g._src_maps) == 3


def _counting(monkeypatch):
    calls = {"shift_blocks": 0, "pack_blocks": 0}
    for name in calls:
        fn = getattr(staging, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(staging, name, counted)
    return calls


def _plans():
    out = []
    for coll in runtime.collectives():
        for algo in mcoll.algorithms(coll):
            out.append((coll, algo, "none"))
            if mcoll.supports_codec(coll, algo):
                out.append((coll, algo, "int8_block"))
    return out


@pytest.mark.parametrize("coll,algo,codec", _plans(),
                         ids=lambda v: str(v))
def test_row_moving_plans_reach_the_staging_wrappers(monkeypatch, coll, algo,
                                                     codec):
    """The plans that move rows go through the staging wrappers (and so
    launch the kernels on the card); the others, the compressed allreduce
    among them, never do (``oracles.moves_rows``, which the smoke test's
    launch checks share)."""
    calls = _counting(monkeypatch)
    comm = Communicator(RankGrid(N, P, "cpu"))
    x = runtime.example_input(coll, comm.topo, 256, device="cpu")
    knobs = {} if codec == "none" else {"codec": codec}
    comm.invoke(coll, x, algo=algo, **knobs)
    moved = calls["shift_blocks"] + calls["pack_blocks"]
    assert (moved > 0) == oracles.moves_rows(coll, algo, codec), calls


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.uint64, torch.bool,
                                   torch.float8_e4m3fn, torch.complex64],
                         ids=str)
@pytest.mark.parametrize("rest", [(), (3,), (5, 4), (1024,), (6, 2)])
def test_cuda_kernels_match_plain(cuda, dtype, rest):
    x = _payload(dtype, (WORLD, 7) + rest, seed=len(rest)).to(cuda)
    r = torch.arange(WORLD, device=cuda)
    for op in (x, x[:, 2:6], x[..., ::2]):
        K = op.shape[1]
        staging.reset_launches()
        for shift in (r, r // P - 5):
            got = staging.shift_blocks(op, shift)
            want = ref.shift_blocks(op, shift)  # on the card, as the kernel
            torch.cuda.synchronize()
            _same_bits(got.cpu(), want.cpu())
            _same_bits(got.cpu(), ref.shift_blocks(op.cpu(), shift.cpu()))
        idx = torch.stack([(r * 3 + k) % (K + 2) - 1 for k in range(5)], 1)
        got = staging.pack_blocks(op, idx)
        torch.cuda.synchronize()
        _same_bits(got.cpu(), ref.pack_blocks(op, idx).cpu())
        flat = torch.tensor([3, -1, 0, 7, 9, 5], device=cuda)
        got = staging.pack_blocks(op, flat)
        torch.cuda.synchronize()
        _same_bits(got.cpu(), ref.pack_blocks(op, flat).cpu())
        assert staging.launches == {"shift_blocks": 2, "pack_blocks": 2}


@pytest.mark.cuda
def test_cuda_zero_size_operands(cuda):
    staging.reset_launches()
    out = staging.pack_blocks(torch.zeros((8, 0, 3), device=cuda),
                              torch.zeros((8, 2), dtype=torch.long,
                                          device=cuda))
    assert out.shape == (8, 2, 3) and not out.any()
    assert staging.launches["pack_blocks"] == 1  # zero rows are written
    staging.reset_launches()
    staging.shift_blocks(torch.zeros((8, 0), device=cuda),
                         torch.zeros(8, dtype=torch.long, device=cuda))
    staging.pack_blocks(torch.zeros((8, 5), device=cuda),
                        torch.zeros(0, dtype=torch.long, device=cuda))
    assert staging.launches == {"shift_blocks": 0, "pack_blocks": 0}


@pytest.mark.cuda
def test_cuda_collectives_go_through_the_kernels(cuda):
    comm = Communicator(RankGrid(N, P, cuda))
    x = runtime.example_input("allgather", comm.topo, 4096, device=cuda)
    staging.reset_launches()
    got = comm.allgather(x, algo="pip_mcoll")
    torch.cuda.synchronize()
    assert staging.launches["shift_blocks"] == 1
    assert staging.launches["pack_blocks"] >= 1
    assert torch.equal(got, oracles.movement("allgather", x, N, P))
