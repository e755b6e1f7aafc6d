"""The port's kernels against the Pallas kernels they replace.

On the CPU each wrapper (`kernels/ops.py`) takes its plain version; both
are held against the Pallas kernel (`join_count_pallas`,
`scatter_append_pallas`, `filter_mask_pallas`, `flash_attention_pallas`)
in interpret mode: exactly for the integer kernels, within the JAX
tests' tolerances for attention (2e-3 in fp32, 3e-2 in bf16).  Each CUDA
kernel itself is compared with its plain version on the card (marked
`cuda`, skipped elsewhere)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import filter_mask as fm  # noqa: E402
from repro_torch.kernels import join_count as jc  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import scatter_append as sa  # noqa: E402

SENTINEL = 2**31 - 1


def _random_join_inputs(rng, n_probe, n_build, key_space, invalid_frac=0.1):
    probe = rng.integers(0, key_space, size=n_probe).astype(np.int32)
    inv = rng.random(n_probe) < invalid_frac
    probe[inv] = -1
    build = np.sort(rng.integers(0, key_space, size=n_build).astype(np.int32))
    n_pad = rng.integers(0, max(n_build // 4, 1))
    build[n_build - n_pad:] = SENTINEL
    return probe, build


def _pallas(probe, build, **kw):
    # imported here: the card's machine runs the `cuda` tests without JAX
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.join_count import join_count_pallas

    lo, cnt = join_count_pallas(jnp.asarray(probe), jnp.asarray(build),
                                interpret=True, **kw)
    return np.asarray(lo), np.asarray(cnt)


def _assert_port_matches(probe, build, **kw):
    want_lo, want_cnt = _pallas(probe, build, **kw)
    tp, tb = torch.from_numpy(probe), torch.from_numpy(build)
    for fn in (ref.join_count_ref, ops.join_count):
        lo, cnt = fn(tp, tb)
        assert lo.dtype == torch.int32 and cnt.dtype == torch.int32
        np.testing.assert_array_equal(lo.numpy(), want_lo)
        np.testing.assert_array_equal(cnt.numpy(), want_cnt)


@pytest.mark.parametrize("n_probe,n_build", [
    (1, 1), (7, 13), (128, 256), (300, 1000), (1024, 64), (513, 511),
])
@pytest.mark.parametrize("key_space", [4, 1000])
def test_join_count_shapes(n_probe, n_build, key_space):
    rng = np.random.default_rng(n_probe * 31 + n_build)
    probe, build = _random_join_inputs(rng, n_probe, n_build, key_space)
    _assert_port_matches(probe, build)


def test_join_count_all_invalid():
    probe = np.full((64,), -1, np.int32)
    build = np.arange(32, dtype=np.int32)
    _assert_port_matches(probe, build)
    _lo, cnt = ops.join_count(torch.from_numpy(probe), torch.from_numpy(build))
    assert int(cnt.sum()) == 0


def test_join_count_duplicates_heavy():
    probe = np.full(200, 7, np.int32)
    build = np.full(300, 7, np.int32)
    _assert_port_matches(probe, build)
    lo, cnt = ops.join_count(torch.from_numpy(probe), torch.from_numpy(build))
    assert int(lo[0]) == 0
    np.testing.assert_array_equal(cnt.numpy(), np.full(200, 300))


def test_property_join_count_random():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=30, deadline=None)
    @given(seed=st.integers(0, 10**6), n_probe=st.integers(1, 400),
           n_build=st.integers(1, 400), ks=st.integers(1, 30))
    def inner(seed, n_probe, n_build, ks):
        rng = np.random.default_rng(seed)
        probe, build = _random_join_inputs(rng, n_probe, n_build, ks)
        _assert_port_matches(probe, build, bl=64, bs=128)

    inner()


@pytest.mark.parametrize("B", [1, 3])
def test_join_count_member_axis(B):
    """(B, L) against (B, S): each row equals the Pallas kernel on that
    member alone — the form one launch serves a join bucket with."""
    rng = np.random.default_rng(B)
    rows = [_random_join_inputs(rng, 300, 517, 40) for _ in range(B)]
    probe = np.stack([p for p, _ in rows])
    build = np.stack([b for _, b in rows])
    lo, cnt = ops.join_count(torch.from_numpy(probe), torch.from_numpy(build))
    assert lo.shape == (B, 300) and cnt.shape == (B, 300)
    for i in range(B):
        want_lo, want_cnt = _pallas(probe[i], build[i])
        np.testing.assert_array_equal(lo[i].numpy(), want_lo)
        np.testing.assert_array_equal(cnt[i].numpy(), want_cnt)


@pytest.mark.parametrize("probe,build,err", [
    (np.zeros(4, np.int64), np.zeros(4, np.int32), TypeError),
    (np.zeros(4, np.int32), np.zeros(4, np.float32), TypeError),
    (np.zeros((2, 2, 2), np.int32), np.zeros((2, 2, 2), np.int32), ValueError),
    (np.zeros(4, np.int32), np.zeros((1, 4), np.int32), ValueError),
    (np.zeros((2, 4), np.int32), np.zeros((3, 4), np.int32), ValueError),
])
def test_join_count_contract(probe, build, err):
    with pytest.raises(err):
        ops.join_count(torch.from_numpy(probe), torch.from_numpy(build))


def test_join_count_contract_non_tensor_and_strided():
    with pytest.raises(TypeError):
        ops.join_count(np.zeros(4, np.int32), torch.zeros(4, dtype=torch.int32))
    strided = torch.zeros((4, 8), dtype=torch.int32)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ops.join_count(strided, torch.zeros((4, 4), dtype=torch.int32))


def test_cpu_path_never_launches():
    before = jc.launches
    rng = np.random.default_rng(5)
    probe, build = _random_join_inputs(rng, 100, 100, 10)
    ops.join_count(torch.from_numpy(probe), torch.from_numpy(build))
    assert jc.launches == before
    if not torch.cuda.is_available():
        assert before == 0


# ----------------------------------------------------------------------
# join_count's sampled search: a numpy transliteration of the CUDA
# kernel's steps (`csrc/join_count.cu`), so the design is held exact here,
# where the kernel cannot run; the kernel itself is held against the plain
# version on the card below
# ----------------------------------------------------------------------
T = jc.MAX_SAMPLES
INT_MAX = 2**31 - 1


def _window_counts(build, start, D, key):
    """window_counts: (#keys < key, #keys <= key) of build[start:start+D]."""
    window = build[start: start + D].astype(np.int64)
    return int((window < key).sum()), int((window <= key).sum())


def _node(r, depth):
    """node(): where the tree keeps its node of in-order rank r."""
    z = (r & -r).bit_length() - 1
    return (1 << (depth - 1 - z)) + (r >> (z + 1)) - 1


def _sampled_search(probe, build, D):
    """(lo, count) of one member as join_count_kernel computes them with
    every D-th key sampled."""
    S = len(build)
    n_samples = -(-S // D)
    assert n_samples <= jc.MAX_SAMPLES
    depth = 0
    while (1 << depth) - 1 < n_samples - 1:
        depth += 1
    tree = [0] * ((1 << depth) - 1)
    for r in range(1, len(tree) + 1):           # Eytzinger staging
        tree[_node(r, depth)] = int(build[r * D]) if r < n_samples \
            else INT_MAX
    lo, count = [], []
    for key in probe.tolist():
        k = 1
        for _ in range(depth):
            k = 2 * k + (tree[k - 1] < key)
        c = k - (1 << depth)
        w0 = c * D
        below, upto = _window_counts(build, w0, D, key)
        lo_i, hi_i = w0 + below, w0 + upto
        if c + 1 < n_samples and tree[_node(c + 1, depth)] == key:
            # the run of equal keys reaches the next window
            k = 1
            for _ in range(depth):
                k = 2 * k + (tree[k - 1] <= key)
            w1 = min(k - (1 << depth), n_samples - 1) * D
            hi_i = w1 + _window_counts(build, w1, D, key)[1]
        lo.append(lo_i)
        count.append(hi_i - lo_i)
    return np.array(lo, np.int32), np.array(count, np.int32)


@pytest.mark.parametrize("S,D", [
    (0, 1), (1, 1), (2, 1), (7, 1), (T - 1, 1), (T, 1),  # the whole row
    (T + 1, 2), (3 * T + 5, 4),                         # sample boundaries
    (3 * T + 5, 64), (5000, 16), (70000, 1024),         # wide windows
])
@pytest.mark.parametrize("key_space", [3, 1000, 10**6])
def test_join_count_sampled_search_is_exact(S, D, key_space):
    """Sample boundaries (S = T-1, T, T+1, 3T+5), S < T, runs of equal keys
    longer than the window (key space 3), SENTINEL_HI tails, keys outside
    the row and at INT32_MAX."""
    rng = np.random.default_rng(S + D + key_space)
    build = np.sort(rng.integers(0, key_space, S)).astype(np.int32)
    build[S - S // 5:] = SENTINEL
    probe = np.concatenate([rng.integers(-1, key_space + 2, 300),
                            [-1, 0, key_space, INT_MAX],
                            build[rng.integers(0, S, 200)] if S else []]
                           ).astype(np.int32)
    lo, count = _sampled_search(probe, build, D)
    want_lo, want_count = ref.join_count_ref(torch.from_numpy(probe),
                                             torch.from_numpy(build))
    np.testing.assert_array_equal(lo, want_lo.numpy())
    np.testing.assert_array_equal(count, want_count.numpy())


def test_join_count_sampled_search_one_run():
    """One run of equal keys across every window of the row."""
    build = np.full(3 * T + 5, 7, np.int32)
    probe = np.array([6, 7, 8, -1], np.int32)
    lo, count = _sampled_search(probe, build, 4)
    np.testing.assert_array_equal(lo, [0, 0, len(build), 0])
    np.testing.assert_array_equal(count, [0, len(build), 0, 0])


@pytest.mark.parametrize("B,L,S", [
    (2, 1 << 19, 1 << 19), (2, 65536, 8192), (1, 256, 1 << 21),
    (4, 4096, 1 << 17), (8, 256, 16384), (1, 1, 1), (3, 1000, 777),
    (1, 5000, (1 << 31) - 1), (200, 10, 50),
])
def test_join_count_plan(B, L, S):
    """The grid fills 132 SMs once or covers L; D is the least power of
    two leaving at most the block's sample size (8 keys a probe with a
    pre-pass, 1 without, MAX_SAMPLES at most); a pre-pass only serves
    several blocks."""
    blocks, D, prepass = jc.plan(B, L, S, 132)
    assert 1 <= blocks <= max(1, -(-132 // B))
    assert blocks in (-(-L // jc.THREADS), -(-132 // B))
    cap = min(jc.MAX_SAMPLES, (8 if blocks > 1 else 1) * -(-L // blocks))
    assert D & (D - 1) == 0 and -(-S // D) <= jc.MAX_SAMPLES
    assert -(-S // D) <= 2 * cap and (D == 1 or -(-S // (D // 2)) > cap)
    assert prepass == (D > 1 and blocks > 1)


def test_join_count_plan_on_the_paths():
    """The query path's probes keep their whole 8,192-key row in shared
    memory (no pre-pass, no scratch); 2^19 probes against 2^19 keys sample
    every 16th key into 32,768; 256 probes against 2^21 keys (the
    maintenance stream's most common shape) are one block, which samples
    256 keys from the row itself."""
    assert jc.plan(2, 65536, 8192, 132) == (64, 1, False)
    assert jc.plan(2, 1 << 19, 1 << 19, 132) == (66, 16, True)
    assert jc.plan(1, 256, 1 << 21, 132) == (1, 8192, False)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,S,key_space", [
    (1, 1, 1, 4), (2, 1000, 777, 4), (3, 4097, 300, 10**6), (1, 255, 257, 50),
])
def test_kernel_matches_plain_on_card(B, L, S, key_space):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(B * L + S)
    rows = [_random_join_inputs(rng, L, S, key_space) for _ in range(B)]
    probe = torch.from_numpy(np.stack([p for p, _ in rows])).cuda()
    build = torch.from_numpy(np.stack([b for _, b in rows])).cuda()
    before = jc.launches
    lo, cnt = ops.join_count(probe, build)
    torch.cuda.synchronize()
    assert jc.launches == before + 1
    want_lo, want_cnt = ref.join_count_ref(probe, build)
    assert torch.equal(lo, want_lo) and torch.equal(cnt, want_cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 100, T - 1, T, T + 1, 3 * T + 5, 1 << 19])
@pytest.mark.parametrize("key_space", [3, 10**6])
def test_join_count_sample_boundaries_on_card(S, key_space):
    """The kernel at the sample boundaries of its design (S = T-1, T, T+1,
    3T+5; S < T; runs of equal keys across windows at key space 3),
    exactly as the plain version, on two members and on one 1-D row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(S + key_space)
    rows = []
    for _ in range(2):
        build = np.sort(rng.integers(0, key_space, S)).astype(np.int32)
        build[S - S // 5:] = SENTINEL
        probe = np.concatenate([rng.integers(-1, key_space + 2, 2000),
                                [-1, 0, INT_MAX],
                                build[rng.integers(0, S, 997)]])
        rows.append((probe.astype(np.int32), build))
    probe = torch.from_numpy(np.stack([p for p, _ in rows])).cuda()
    build = torch.from_numpy(np.stack([b for _, b in rows])).cuda()
    before = jc.launches
    for p, b in ((probe, build), (probe[1].contiguous(), build[1].contiguous())):
        lo, cnt = ops.join_count(p, b)
        torch.cuda.synchronize()
        want_lo, want_cnt = ref.join_count_ref(p, b)
        assert lo.shape == p.shape and cnt.shape == p.shape
        assert torch.equal(lo, want_lo) and torch.equal(cnt, want_cnt)
    assert jc.launches == before + 2


@pytest.mark.cuda
def test_join_count_edge_rows_on_card():
    """All-invalid probes, a row of SENTINEL_HI only, one long run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    probe = torch.tensor([[-1] * 700, [5] * 700], dtype=torch.int32,
                         device="cuda")
    for build in (torch.full((2, 3 * T + 5), SENTINEL, dtype=torch.int32),
                  torch.full((2, 3 * T + 5), 5, dtype=torch.int32),
                  torch.arange(2 * (T + 1), dtype=torch.int32).view(2, -1)):
        build = build.cuda()
        lo, cnt = ops.join_count(probe, build)
        want_lo, want_cnt = ref.join_count_ref(probe, build)
        assert torch.equal(lo, want_lo) and torch.equal(cnt, want_cnt)


@pytest.mark.cuda
def test_session_on_card_matches_cpu():
    """The wizard's query path on the card, joins through the kernel,
    answers exactly as the same session on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.api import TuningSession
    from repro_torch.rdf.generator import generate, lubm_workload

    uni = generate(n_universities=2, seed=0)
    wl = lubm_workload(uni.dictionary)
    cpu = TuningSession(uni.store, wl, schema=uni.schema, device="cpu")
    card = TuningSession(uni.store, wl, schema=uni.schema, device="cuda")
    before = jc.launches
    for q in wl:
        assert card.answer(q.name) == cpu.answer(q.name), q.name
    assert jc.launches > before


# ----------------------------------------------------------------------
# scatter_append: the streaming-maintenance extent append
# ----------------------------------------------------------------------

def _append_inputs(rng, cap, n, dcap, w):
    buf = np.full((cap, w), -1, np.int32)
    buf[:n] = rng.integers(0, 99, (n, w))
    rows = rng.integers(0, 99, (dcap, w)).astype(np.int32)
    return buf, rows


def _scatter_pallas(buf, rows, n, k):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.scatter_append import scatter_append_pallas

    return np.asarray(scatter_append_pallas(
        jnp.asarray(buf), jnp.asarray(rows),
        jnp.asarray([[n, k]], dtype=jnp.int32), interpret=True))


@pytest.mark.parametrize("cap,n,dcap,k,w", [
    # the cases of the JAX package's own kernel test
    (128, 0, 64, 0, 3), (128, 100, 64, 28, 3), (256, 5, 128, 128, 2),
    (128, 127, 128, 1, 4),
    (256, 40, 64, 0, 3),        # k = 0
    (256, 192, 64, 64, 3),      # n + k = cap
    (700, 300, 256, 200, 3),    # cap not a multiple of 512
    (1300, 1044, 256, 256, 3),  # ... with the append across a 512 boundary
])
def test_scatter_append_matches_pallas(cap, n, dcap, k, w):
    rng = np.random.default_rng(cap + n + k)
    buf, rows = _append_inputs(rng, cap, n, dcap, w)
    want = _scatter_pallas(buf, rows, n, k)
    expect = buf.copy()
    expect[n:n + k] = rows[:k]
    np.testing.assert_array_equal(want, expect)
    tb, tr = torch.from_numpy(buf), torch.from_numpy(rows)
    nk = torch.tensor([[n, k]], dtype=torch.int32)
    for got in (ops.scatter_append(tb, n, tr, k),
                ops.scatter_append(tb, torch.tensor(n), tr, torch.tensor(k)),
                ref.scatter_append_ref(tb, tr, nk)):
        assert got.dtype == torch.int32 and got.shape == (cap, w)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tb.numpy(), buf)  # a new buffer


def test_scatter_append_ref_past_delta_capacity_reads_zero():
    """Counts passed as device data are not checked; a slot past the delta
    buffer reads 0, as the Pallas kernel's does."""
    rng = np.random.default_rng(3)
    buf, rows = _append_inputs(rng, 128, 10, 16, 3)
    want = _scatter_pallas(buf, rows, 10, 40)
    got = ref.scatter_append_ref(torch.from_numpy(buf), torch.from_numpy(rows),
                                 torch.tensor([[10, 40]], dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cap,n,dcap,k,err,match", [
    (128, 120, 16, 16, ValueError, "overflows capacity"),
    (128, 0, 16, 17, ValueError, "exceeds delta buffer"),
    (128, -1, 16, 1, ValueError, "non-negative"),
    (128, 0, 16, -1, ValueError, "non-negative"),
])
def test_scatter_append_rejects(cap, n, dcap, k, err, match):
    buf = torch.zeros((cap, 3), dtype=torch.int32)
    with pytest.raises(err, match=match):
        ops.scatter_append(buf, n, torch.zeros((dcap, 3), dtype=torch.int32),
                           k)


def test_scatter_append_contract():
    buf = torch.zeros((128, 3), dtype=torch.int32)
    rows = torch.zeros((16, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.scatter_append(buf.long(), 0, rows, 1)
    with pytest.raises(ValueError, match="width"):
        ops.scatter_append(buf, 0, torch.zeros((16, 2), dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        ops.scatter_append(buf[None], 0, rows, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.scatter_append(torch.zeros((128, 6), dtype=torch.int32)[:, ::2],
                           0, rows, 1)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_scatter_append_host_ints_and_scalar_tensors_agree(dtype):
    """Host ints (passed to the kernel by value on the card) and 0-d
    tensors on the buffer's device (read there) give one result."""
    rng = np.random.default_rng(11)
    buf, rows = _append_inputs(rng, 700, 301, 256, 3)
    tb, tr = torch.from_numpy(buf), torch.from_numpy(rows)
    by_value = ops.scatter_append(tb, 301, tr, 200)
    as_data = ops.scatter_append(tb, torch.tensor(301, dtype=dtype), tr,
                                 torch.tensor(200, dtype=dtype))
    assert torch.equal(by_value, as_data)
    np.testing.assert_array_equal(by_value.numpy(),
                                  _scatter_pallas(buf, rows, 301, 200))


# ----------------------------------------------------------------------
# filter_mask: selection-cut compensation mask + block popcounts
# ----------------------------------------------------------------------
def _filter_pallas(rows, conds):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.filter_compact import filter_mask_pallas

    mask, counts = filter_mask_pallas(jnp.asarray(rows), conds,
                                      interpret=True)
    return np.asarray(mask), np.asarray(counts)


@pytest.mark.parametrize("N", [1, 511, 512, 513, 2000])
@pytest.mark.parametrize("conds", [(), ((1, 2),), ((1, 2), (2, 0), (0, 1))])
def test_filter_mask_matches_pallas(N, conds):
    rng = np.random.default_rng(N)
    rows = rng.integers(0, 3, (N, 3)).astype(np.int32)
    rows[rng.random(N) < 0.2, 0] = -1       # invalid rows
    want_mask, want_counts = _filter_pallas(rows, conds)
    for fn in (ops.filter_mask, ref.filter_mask_ref):
        mask, counts = fn(torch.from_numpy(rows), conds)
        assert mask.dtype == torch.int32 and counts.dtype == torch.int32
        np.testing.assert_array_equal(mask.numpy(), want_mask)
        np.testing.assert_array_equal(counts.numpy(), want_counts)
    assert counts.shape == (-(-N // 512),)


def test_filter_mask_invalid_rows_never_pass():
    rows = np.full((600, 2), -1, np.int32)
    want_mask, want_counts = _filter_pallas(rows, ((1, -1),))
    mask, counts = ops.filter_mask(torch.from_numpy(rows), ((1, -1),))
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    assert int(mask.sum()) == 0 and int(counts.sum()) == 0


@pytest.mark.parametrize("conds,err", [
    (((3, 1),), ValueError),
    (((-1, 1),), ValueError),
    (((0, 1, 2),), TypeError),
    (((0, 1.5),), TypeError),
])
def test_filter_mask_rejects(conds, err):
    with pytest.raises(err):
        ops.filter_mask(torch.zeros((8, 3), dtype=torch.int32), conds)


def test_filter_mask_contract():
    with pytest.raises(TypeError):
        ops.filter_mask(torch.zeros((8, 3), dtype=torch.int64), ())
    with pytest.raises(ValueError):
        ops.filter_mask(torch.zeros(8, dtype=torch.int32), ())


def test_cpu_path_never_launches_new_kernels():
    before = (sa.launches, fm.launches)
    ops.scatter_append(torch.zeros((128, 3), dtype=torch.int32), 0,
                       torch.ones((8, 3), dtype=torch.int32), 8)
    ops.filter_mask(torch.zeros((8, 3), dtype=torch.int32), ((1, 0),))
    assert (sa.launches, fm.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n,dcap,k", [
    (128, 0, 64, 0), (700, 300, 256, 200), (1 << 19, (1 << 19) - 256, 256,
                                             256),
])
def test_scatter_append_kernel_matches_plain_on_card(cap, n, dcap, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(cap + n)
    buf, rows = _append_inputs(rng, cap, n, dcap, 3)
    tb, tr = torch.from_numpy(buf).cuda(), torch.from_numpy(rows).cuda()
    keep = tb.clone()
    before = sa.launches
    got = ops.scatter_append(tb, n, tr, k)
    torch.cuda.synchronize()
    assert sa.launches == before + 1
    want = ref.scatter_append_ref(tb, tr, torch.tensor(
        [[n, k]], dtype=torch.int32, device="cuda"))
    assert torch.equal(got, want) and torch.equal(tb, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n,dcap,k,w,offset", [
    (700, 301, 256, 200, 3, 0),     # n*W = 903: the window starts mid-vector
    (1025, 5, 16, 13, 3, 0),        # ... and cap*W = 3075 leaves a tail
    (999, 333, 64, 64, 5, 0),
    (128, 1, 64, 0, 3, 0),          # k = 0 inside a vector
    (1 << 19, 3, 256, 255, 3, 0),
    (700, 301, 256, 200, 3, 1),     # a buffer 4 bytes off 16-byte alignment
])
def test_scatter_append_counts_by_value_on_card(cap, n, dcap, k, w, offset):
    """n, k by value (the maintainer's launch) against the device-nk entry
    and the plain version, at n*W not a multiple of 4 words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(cap + n + offset)
    buf, rows = _append_inputs(rng, cap, n, dcap, w)
    tb = torch.empty(cap * w + offset, dtype=torch.int32, device="cuda")[
        offset:].view(cap, w)
    tb.copy_(torch.from_numpy(buf))
    tr = torch.from_numpy(rows).cuda()
    keep = tb.clone()
    nk = torch.tensor([[n, k]], dtype=torch.int32, device="cuda")
    before = sa.launches
    by_value = ops.scatter_append(tb, n, tr, k)
    on_device = sa.scatter_append_cuda(tb, tr, nk)
    as_tensors = ops.scatter_append(tb, nk[0, 0], tr, nk[0, 1])
    torch.cuda.synchronize()
    assert sa.launches == before + 3
    want = ref.scatter_append_ref(tb, tr, nk)
    for got in (by_value, on_device, as_tensors):
        assert torch.equal(got, want)
    assert torch.equal(tb, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 513, 1 << 20])
@pytest.mark.parametrize("conds", [(), ((1, 2),), ((1, 2), (2, 0))])
def test_filter_mask_kernel_matches_plain_on_card(N, conds):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(N)
    rows = rng.integers(0, 3, (N, 3)).astype(np.int32)
    rows[rng.random(N) < 0.2, 0] = -1
    tr = torch.from_numpy(rows).cuda()
    before = fm.launches
    mask, counts = ops.filter_mask(tr, conds)
    torch.cuda.synchronize()
    assert fm.launches == before + 1
    want_mask, want_counts = ref.filter_mask_ref(tr, conds)
    assert torch.equal(mask, want_mask) and torch.equal(counts, want_counts)


# ----------------------------------------------------------------------
# flash_attention: the causal GQA attention of the LM prefill
# ----------------------------------------------------------------------
from repro_torch.kernels import flash_attn as fa  # noqa: E402


def _attn_inputs(seed, B, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, hd)).astype(np.float32))


def _flash_jax(q, k, v, window, pallas: bool, dtype=None):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels.flash_attn import flash_attention_pallas

    args = [jnp.asarray(x) if dtype is None else jnp.asarray(x).astype(dtype)
            for x in (q, k, v)]
    if pallas:
        out = flash_attention_pallas(*args, window=window, cq=16, ck=16,
                                     interpret=True)
    else:
        out = jref.flash_attention_ref(*args, window=window)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("B,S,H,Hkv,hd", [
    (1, 32, 4, 2, 16), (2, 64, 4, 4, 32), (1, 128, 8, 2, 16),
])
@pytest.mark.parametrize("window", [0, 16])
def test_flash_attention_matches_pallas(B, S, H, Hkv, hd, window):
    """The cases of the JAX package's kernel test, fp32, tolerance 2e-3
    (its own): the port's wrapper (plain version on the CPU) and its
    plain version against the Pallas kernel and the JAX oracle."""
    q, k, v = _attn_inputs(B * 97 + S + window, B, S, H, Hkv, hd)
    pallas = _flash_jax(q, k, v, window, pallas=True)
    oracle = _flash_jax(q, k, v, window, pallas=False)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for got in (ops.flash_attention(tq, tk, tv, window),
                ref.flash_attention_ref(tq, tk, tv, window)):
        assert got.dtype == torch.float32 and got.shape == (B, S, H, hd)
        np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-3, atol=2e-3)


def test_flash_attention_bf16():
    """bf16 in, bf16 out, tolerance 3e-2 (the JAX test's)."""
    q, k, v = _attn_inputs(6, 1, 32, 2, 2, 16)
    import jax.numpy as jnp

    want = _flash_jax(q, k, v, 0, pallas=True, dtype=jnp.bfloat16)
    got = ops.flash_attention(*(torch.from_numpy(x).bfloat16()
                                for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("S,window", [(1, 0), (37, 0), (37, 5), (100, 64)])
def test_flash_attention_any_length(S, window):
    """The kernel masks its tail tile, so S need not be a multiple of a
    block (the Pallas kernel's S % 128 rule is its TPU block specs'):
    held against the JAX oracle, fp32, 2e-3."""
    q, k, v = _attn_inputs(S + window, 2, S, 4, 1, 32)
    want = _flash_jax(q, k, v, window, pallas=False)
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


_Q = torch.zeros((1, 8, 4, 16))
_KV = torch.zeros((1, 8, 2, 16))


@pytest.mark.parametrize("args,kw,err,match", [
    ((_Q[0], _KV, _KV), {}, ValueError, "4-D"),
    ((_Q, _KV, torch.zeros((1, 8, 1, 16))), {}, ValueError, "must agree"),
    ((_Q, torch.zeros((2, 8, 2, 16)), torch.zeros((2, 8, 2, 16))), {},
     ValueError, "incompatible"),
    ((_Q, torch.zeros((1, 8, 3, 16)), torch.zeros((1, 8, 3, 16))), {},
     ValueError, "multiple of kv heads"),
    ((_Q, _KV, _KV), {"window": -1}, ValueError, "non-negative int"),
    ((_Q, _KV, _KV), {"window": 2.0}, ValueError, "non-negative int"),
    ((_Q.double(), _KV.double(), _KV.double()), {}, TypeError, "dtype"),
    ((_Q.bfloat16(), _KV, _KV), {}, TypeError, "dtype"),
    ((torch.zeros((1, 8, 4, 24)), torch.zeros((1, 8, 2, 24)),
      torch.zeros((1, 8, 2, 24))), {}, ValueError, "head dim 24"),
    ((torch.zeros((1, 8, 8, 16))[:, :, ::2], _KV, _KV), {}, ValueError,
     "contiguous"),
    ((_Q.numpy(), _KV, _KV), {}, TypeError, "torch.Tensor"),
])
def test_flash_attention_contract(args, kw, err, match):
    with pytest.raises(err, match=match):
        ops.flash_attention(*args, **kw)


def test_flash_attention_cpu_path_never_launches():
    before, by_design = fa.launches, dict(fa.design_launches)
    ops.flash_attention(_Q, _KV, _KV, 4)
    ops.flash_attention(_Q.bfloat16(), _KV.bfloat16(), _KV.bfloat16(), 4)
    assert fa.launches == before and fa.design_launches == by_design


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(fa.DTYPES))
def test_flash_attention_design_by_dtype_and_head_dim(dtype, hd):
    """One plain function picks the design from (dtype, hd): the
    tensor-core kernel serves bf16 at hd 64, 128 and 256, the CUDA-core
    kernel fp32 and the narrow heads."""
    want = ("tensor_core" if dtype == torch.bfloat16 and hd >= 64
            else "cuda_core")
    assert fa.design(dtype, hd) == want
    assert want in fa.DESIGNS and want in fa.design_launches
    if want == "tensor_core":
        assert hd in fa.TENSOR_CORE_HEAD_DIMS


def test_build_hash_covers_headers_and_flags(tmp_path, monkeypatch):
    """The library's name hashes the source, every local header it
    includes (recursively) and the flags, and the build command carries
    the flags; no nvcc needed."""
    from repro_torch.kernels import _build

    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\n'
                                   'int f() { return g(); }\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint g();\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "unrelated.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda name: "nvcc")
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _build.library_path("k")
    (tmp_path / "unrelated.cuh").write_text("// changed\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, changed\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("k-")
    flags = (*_build.NVCC_FLAGS, "-I/usr/local/cutlass/include", "-lcuda")
    monkeypatch.setattr(_build, "NVCC_FLAGS", flags)
    assert _build.library_path("k") != second
    cmd = _build.command("k", "out.so")
    assert cmd[0] == "nvcc" and cmd[-1] == str(tmp_path / "k.cu")
    assert tuple(cmd[1:1 + len(flags)]) == flags
    assert cmd[cmd.index("-o") + 1] == "out.so"


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,hd,window,dtype,want", [
    (1, 1, 4, 2, 16, 0, torch.float32, "cuda_core"),
    (2, 100, 4, 1, 32, 0, torch.float32, "cuda_core"),
    (1, 130, 8, 8, 64, 17, torch.float32, "cuda_core"),
    (1, 300, 4, 2, 128, 0, torch.float32, "cuda_core"),
    (1, 257, 4, 2, 256, 64, torch.float32, "cuda_core"),
    (1, 100, 4, 2, 32, 9, torch.bfloat16, "cuda_core"),
    (2, 512, 16, 8, 256, 0, torch.bfloat16, "tensor_core"),
    (2, 512, 16, 8, 256, 128, torch.bfloat16, "tensor_core"),
    (1, 200, 4, 4, 128, 33, torch.bfloat16, "tensor_core"),
    # the LM prefill's two shapes (gemma3-12b, 4 x 2,048 tokens)
    (4, 2048, 16, 8, 256, 0, torch.bfloat16, "tensor_core"),
    (4, 2048, 16, 8, 256, 1024, torch.bfloat16, "tensor_core"),
    # one query tile: only the diagonal tile; then a one-row tail
    (2, 64, 16, 8, 256, 0, torch.bfloat16, "tensor_core"),
    (2, 65, 16, 8, 256, 0, torch.bfloat16, "tensor_core"),
    (3, 1, 4, 2, 64, 0, torch.bfloat16, "tensor_core"),
    # MQA and no grouping
    (1, 300, 8, 1, 256, 100, torch.bfloat16, "tensor_core"),
    (1, 300, 8, 8, 256, 0, torch.bfloat16, "tensor_core"),
    # the other tensor-core widths
    (2, 333, 4, 2, 64, 0, torch.bfloat16, "tensor_core"),
    (2, 333, 4, 2, 64, 70, torch.bfloat16, "tensor_core"),
    (2, 333, 4, 2, 128, 0, torch.bfloat16, "tensor_core"),
    (2, 333, 4, 2, 128, 50, torch.bfloat16, "tensor_core"),
])
def test_flash_attention_kernel_matches_plain_on_card(B, S, H, Hkv, hd,
                                                      window, dtype, want):
    """The CUDA kernel against its plain version on the card: 2e-3 in
    fp32 (the JAX kernel tests' tolerance); in bf16 one bf16 ulp
    (1e-4 + 2**-7 |want|), since both compute in fp32 and round once
    (the tensor-core design splits P into two bf16 halves to keep that
    true).  The launch must have gone through the design that
    `flash_attn.design` names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (torch.from_numpy(x).to("cuda", dtype)
               for x in _attn_inputs(S + hd, B, S, H, Hkv, hd))
    assert fa.design(dtype, hd) == want
    before, by_design = fa.launches, fa.design_launches[want]
    got = ops.flash_attention(q, k, v, window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert fa.design_launches[want] == by_design + 1
    ref_out = ref.flash_attention_ref(q, k, v, window)
    atol, rtol = (2e-3, 2e-3) if dtype == torch.float32 else (1e-4, 2 ** -7)
    assert got.dtype == dtype and got.shape == (B, S, H, hd)
    torch.testing.assert_close(got.float(), ref_out.float(), rtol=rtol,
                               atol=atol)


# ----------------------------------------------------------------------
# shape rules on `meta`: what the plain version gives on the CPU
# ----------------------------------------------------------------------
def _meta(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


def _same_shapes(got, want) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [(t.device.type, tuple(t.shape), t.dtype) for t in got] == \
        [("meta", tuple(t.shape), t.dtype) for t in want]


@pytest.mark.parametrize("N", [0, 1, 511, 512, 513, 2000])
@pytest.mark.parametrize("conds", [(), ((1, 2),), ((1, 2), (2, 0))])
def test_filter_mask_shape_rule_on_meta(N, conds):
    rows = torch.from_numpy(np.random.default_rng(N).integers(
        -1, 3, (N, 3), dtype=np.int32))
    _same_shapes(ops.filter_mask(_meta(rows), conds),
                 ops.filter_mask(rows, conds))


@pytest.mark.parametrize("cap,n,dcap,k,w", [
    (64, 0, 8, 8, 3), (64, 60, 8, 4, 3), (32, 5, 0, 0, 2), (0, 0, 4, 0, 3)])
@pytest.mark.parametrize("as_tensors", [False, True])
def test_scatter_append_shape_rule_on_meta(cap, n, dcap, k, w, as_tensors):
    buf = torch.zeros((cap, w), dtype=torch.int32)
    rows = torch.ones((dcap, w), dtype=torch.int32)
    nk = ((torch.tensor(n, dtype=torch.int32), torch.tensor(k, dtype=torch.int32))
          if as_tensors else (n, k))
    want = ops.scatter_append(buf, nk[0], rows, nk[1])
    meta_nk = tuple(_meta(x) for x in nk) if as_tensors else nk
    _same_shapes(ops.scatter_append(_meta(buf), meta_nk[0], _meta(rows),
                                    meta_nk[1]), want)


@pytest.mark.parametrize("B,S,H,Hkv,hd,window", [
    (2, 16, 4, 2, 16, 0), (1, 37, 4, 4, 32, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_shape_rule_on_meta(B, S, H, Hkv, hd, window, dtype):
    """The forward's shape rule, its flop formula under FlopCounterMode
    (4 * hd per unmasked pair per head) and, on `meta`, the backward
    (`attention_backward`) with gradients shaped like the inputs."""
    from torch.utils.flop_counter import FlopCounterMode

    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _attn_inputs(S, B, S, H, Hkv, hd))
    want = ops.flash_attention(q, k, v, window)
    qm, km, vm = (_meta(x).requires_grad_() for x in (q, k, v))
    with FlopCounterMode(display=False) as fc:
        got = ops.flash_attention(qm, km, vm, window)
    _same_shapes(got, want)
    pairs = sum(min(s + 1, window) if window else s + 1 for s in range(S))
    assert ops.attention_pairs(S, window) == pairs
    assert fc.get_total_flops() == 4 * hd * B * H * pairs
    got.sum().backward()
    for x in (qm, km, vm):
        assert x.grad.device.type == "meta" and x.grad.shape == x.shape \
            and x.grad.dtype == x.dtype
