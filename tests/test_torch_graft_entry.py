"""The port's graft entry points (elprep_tpu_torch.graft_entry, torch on
the CPU) against the JAX package's root ``__graft_entry__.py`` on the same
columns: the column builders array for array, the fused single-device
step (dense and packed), ``entry()`` and ``sync_scalar`` bit for bit
(integer outputs, tolerance 0; the port's sort permutation is int64 where
JAX's is int32, so it is compared as values), and the multi-device dryrun
on a mesh of eight CPU entries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jge
from elprep_tpu.ops import pairhmm as jax_pairhmm
from elprep_tpu_torch import device as tdevice
from elprep_tpu_torch import graft_entry as ge
from elprep_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

# (reads, read length): the packed tests' size, bench.py's read length,
# and an odd length (one nibble of padding per row)
SIZES = [(256, 96), (256, 128), (1000, 151)]
REF_LEN = 4096


@pytest.fixture(autouse=True)
def _restore_jax_pairhmm_state(monkeypatch):
    """Each test gets fresh JAX PairHMM module state, and the state before
    it comes back after it, so no later test on the same worker sees a
    mesh or backend this file left behind."""
    monkeypatch.setattr(jax_pairhmm, "_MESH", [None])
    monkeypatch.setattr(jax_pairhmm, "_SESSION_BACKEND", [None])


def _columns(n_reads, read_len):
    return (jge.fused_step_columns(n_reads, read_len, REF_LEN),
            ge.fused_step_columns(n_reads, read_len, REF_LEN))


def _assert_same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def _assert_same_outputs(port, jax_out):
    """Port tensors equal JAX arrays value for value, shape for shape."""
    assert len(port) == len(jax_out)
    for p, j in zip(port, jax_out):
        p, j = p.numpy(), np.asarray(j)
        assert p.shape == j.shape
        assert np.array_equal(p, j)


@pytest.mark.parametrize("n_reads,read_len", SIZES)
def test_columns_match_jax(n_reads, read_len):
    jcols, cols = _columns(n_reads, read_len)
    _assert_same_arrays(cols, jcols)
    _assert_same_arrays(ge.pack_step_columns(cols), jge.pack_step_columns(jcols))


def test_pack_step_columns_none_past_16_symbols():
    jcols, cols = _columns(64, 32)
    for c in (jcols, cols):
        c[0] = (np.arange(c[0].size) % 17 + 60).astype(np.uint8).reshape(c[0].shape)
    assert jge.pack_step_columns(jcols) is None
    assert ge.pack_step_columns(cols) is None


@pytest.mark.parametrize("n_reads,read_len,n_rg,max_cycle",
                         [s + (1, 512) for s in SIZES] + [(256, 128, 2, 300)])
def test_fused_step_matches_jax(n_reads, read_len, n_rg, max_cycle):
    jcols, cols = _columns(n_reads, read_len)
    want = jge.fused_device_step(n_rg=n_rg, max_cycle=max_cycle)(
        *[jnp.asarray(c) for c in jcols])
    got = ge.fused_device_step(n_rg=n_rg, max_cycle=max_cycle, device="cpu")(*cols)
    assert [t.device.type for t in got] == ["cpu"] * 4
    assert got[0].dtype == torch.int64 and np.asarray(want[0]).dtype == np.int32
    _assert_same_outputs(got, want)
    # the plain version is the same composition
    eager = ge.fused_device_step_eager(n_rg=n_rg, max_cycle=max_cycle, device="cpu")(*cols)
    for a, b in zip(eager, got):
        assert torch.equal(a, b)
    assert ge.sync_scalar(got) == jge.sync_scalar(want)


@pytest.mark.parametrize("n_reads,read_len", SIZES)
def test_packed_step_matches_dense_and_jax(n_reads, read_len):
    jcols, cols = _columns(n_reads, read_len)
    dense = ge.fused_device_step(device="cpu")(*cols)
    got = ge.fused_device_step_packed(width=read_len, device="cpu")(
        *ge.pack_step_columns(cols))
    for a, b in zip(got, dense):
        assert torch.equal(a, b)
    want = jge.fused_device_step_packed(width=read_len)(
        *[jnp.asarray(c) for c in jge.pack_step_columns(jcols)])
    _assert_same_outputs(got, want)


def test_entry_matches_jax():
    fn, args = ge.entry("cpu")
    jfn, jargs = jge.entry()
    assert len(args) == len(jargs) == 14
    assert all(a.device.type == "cpu" for a in args)
    _assert_same_arrays([a.numpy() for a in args], [np.asarray(a) for a in jargs])
    got = fn(*args)
    want = jfn(*jargs)
    _assert_same_outputs(got, want)
    assert ge.sync_scalar(got) == jge.sync_scalar(want)


@pytest.mark.parametrize("tree", ["tuple", "dict", "nested_with_empty"])
def test_sync_scalar_matches_jax(tree):
    cols = ge.fused_step_columns(256, 96, REF_LEN)
    out = ge.fused_device_step(device="cpu")(*cols)
    jout = tuple(jnp.asarray(t.numpy()) for t in out)
    if tree == "dict":
        out, jout = ({k: v for k, v in zip("dcba", o)} for o in (out, jout))
    elif tree == "nested_with_empty":
        out = [out[:2], (torch.zeros(0), out[2:])]
        jout = [jout[:2], (jnp.zeros(0), jout[2:])]
    got = ge.sync_scalar(out)
    assert isinstance(got, float)
    assert got == jge.sync_scalar(jout)


def test_fused_step_asks_for_cuda_by_default():
    """The session default is cuda: without a card the step raises rather
    than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(tdevice.DeviceUnavailable):
        ge.fused_device_step(device="cuda")
    with pytest.raises(tdevice.DeviceUnavailable):
        ge.entry("cuda")


def test_dryrun_multichip_cpu8():
    """dryrun_multichip(8) on a mesh of eight CPU entries: the sharded
    sort+dedup step against the host twins, the PairHMM over every entry,
    ``filter --sharded`` == the whole-file run, two gloo processes ==
    a whole-file run; the mesh size and the session device come back."""
    before = (pmesh._LOCAL_DEVICES[0], tdevice._DEFAULT[0])
    ge.dryrun_multichip(8, device="cpu")
    assert (pmesh._LOCAL_DEVICES[0], tdevice._DEFAULT[0]) == before
