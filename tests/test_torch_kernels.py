"""The port's join probe against the Pallas kernel it replaces.

On the CPU the wrapper (`kernels/ops.join_count`) takes the plain
version; both are held against `join_count_pallas` in interpret mode,
with exact equality.  The CUDA kernel itself is compared with the plain
version on the card (marked `cuda`, skipped elsewhere)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import join_count as jc  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

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
