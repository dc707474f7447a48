"""The keys' short-coefficient samplers on the CPU: the port's own binding of
the C sampler (``native.sample_short_batch``) and kernel ``sample_short``'s
per-stream functions (``csrc/sample_short.cu``, built with the host C++
compiler, a serial loop over the streams in place of the grid), each held
to CPython's ``random`` (``hashing.sampler.sample_short_poly_coeffs``) at
the seeds where CPython's key changes length; and ``_sample_sk``'s route
off the card.  The kernel on the card: tests/test_torch_cuda_kernels.py."""
import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from fusion_cryptography_tpu_torch import fusion_setup, native
from fusion_cryptography_tpu_torch.hashing.sampler import sample_short_poly_coeffs
from fusion_cryptography_tpu_torch.ops import sample_short as ss
from fusion_cryptography_tpu_torch.ops.field import Q
from fusion_cryptography_tpu_torch.scheme import device_setup as ds

CSRC = Path(__file__).resolve().parents[1] / "fusion_cryptography_tpu_torch" / "csrc"

# 2**32 - 1 + 1 takes two key words, 2**32 is the first seed of two
BOUNDARY_SEEDS = [0, 1, 42, 2**31, 2**32 - 1, 2**32, 2**63, 2**64 - 2]
# (degree, norm bound, weight bound): secpar 128's keys, a partial weight
# (the Fisher-Yates pass), secpar 256's keys
SHAPES = [(64, 52, 64), (256, 52, 60), (256, 52, 256)]


def _python(seeds, degree, norm_bound, weight_bound, modulus=Q) -> np.ndarray:
    return np.stack([sample_short_poly_coeffs(modulus, degree, norm_bound, weight_bound, s)
                     for s in seeds]).reshape(-1, degree)


def test_mt_init_words_seed_cpython():
    """The table the kernel starts every seeding from is CPython's
    init_genrand(19650218): seeding from it as init_by_array does gives
    random.seed's state."""
    init = ss.mt_init_words().tolist()
    for seed in (0, 2**32 + 7):
        key = [seed & 0xFFFFFFFF] + ([seed >> 32] if seed >> 32 else [])
        mt, i, j = list(init), 1, 0
        for _ in range(max(624, len(key))):
            mt[i] = ((mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1664525)) + key[j] + j) \
                & 0xFFFFFFFF
            i, j = i + 1, (j + 1) % len(key)
            if i >= 624:
                mt[0], i = mt[623], 1
        for _ in range(623):
            mt[i] = ((mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1566083941)) - i) & 0xFFFFFFFF
            i += 1
            if i >= 624:
                mt[0], i = mt[623], 1
        mt[0] = 0x80000000
        state = random.getstate()
        random.seed(seed)
        seeded = random.getstate()
        random.setstate(state)
        assert list(seeded[1][:624]) == mt


@pytest.mark.skipif(not native.available(), reason="needs gcc for the C sampler")
@pytest.mark.parametrize("degree,norm_bound,weight_bound", SHAPES)
def test_port_native_binding_matches_cpython(degree, norm_bound, weight_bound):
    got = native.sample_short_batch(BOUNDARY_SEEDS, degree, norm_bound, weight_bound, Q)
    assert got.dtype == np.int32
    assert np.array_equal(got, _python(BOUNDARY_SEEDS, degree, norm_bound, weight_bound))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("sample_host")
    src = out / "sample_loops.cpp"
    src.write_text(r"""
#include <vector>

#include "sample_short.cu"

// Every stream as the grid's threads draw it, lane t % 32's column of one
// block's shared state.
extern "C" void host_sample_short(const uint64_t* seeds, int64_t keys, const uint32_t* init,
                                  int degree, int norm_bound, int weight_bound, int64_t modulus,
                                  int32_t* out) {
  const SampleLimits lim = sample_limits(degree, norm_bound, weight_bound, modulus);
  std::vector<uint32_t> state((std::size_t)kMtN * kSampleThreads);
  for (int64_t t = 0; t < 2 * keys; ++t)
    sample_stream<kSampleThreads>(state.data() + t % kSampleThreads, init,
                                  seeds[t >> 1] + (uint64_t)(t & 1), degree, lim.num, lim.bound,
                                  out + t * degree);
}
""")
    so = out / "libsample_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.host_sample_short.argtypes = [P, I64, P, I32, I32, I32, I64, P]
    lib.host_sample_short.restype = None
    return lib


def _host_kernel(lib, seeds, degree, norm_bound, weight_bound, modulus=Q) -> np.ndarray:
    """The kernel's streams for keys ``seeds`` -> int32[B, 2, degree], on an
    output filled with -1."""
    s = np.asarray(seeds, dtype=np.uint64)
    out = np.full((len(s), 2, degree), -1, dtype=np.int32)
    init = ss.mt_init_words()
    lib.host_sample_short(s.ctypes.data, len(s), init.ctypes.data, degree, norm_bound,
                          weight_bound, modulus, out.ctypes.data)
    return out


@pytest.mark.parametrize("degree,norm_bound,weight_bound", SHAPES)
def test_kernel_streams_match_cpython(host_lib, degree, norm_bound, weight_bound):
    """Row 0 of key b is seed s's polynomial and row 1 that of s + 1, at
    the boundary seeds and across 2**32 (consecutive keys)."""
    for seeds in (BOUNDARY_SEEDS, list(range(2**32 - 100, 2**32 + 100))):
        got = _host_kernel(host_lib, seeds, degree, norm_bound, weight_bound)
        want = _python([x for s in seeds for x in (s, s + 1)], degree, norm_bound,
                       weight_bound)
        assert np.array_equal(got.reshape(-1, degree), want)


@pytest.mark.parametrize("degree,norm_bound,weight_bound,modulus", [
    (1, 1, 1, Q), (8, 1, 3, Q), (8, 2**31 - 1, 8, 2**40), (8, 52, 0, Q), (8, 52, -5, Q),
    (5, 52, 7, 7), (33, 3, 20, Q)])
def test_kernel_streams_match_cpython_at_edge_limits(host_lib, degree, norm_bound,
                                                     weight_bound, modulus):
    """Bounds of one value and of 2**31 - 1 (31-bit draws), no weight, a
    weight past the degree, a modulus that sets the bound, an odd degree."""
    seeds = [0, 7, 2**32 - 1]
    got = _host_kernel(host_lib, seeds, degree, norm_bound, weight_bound, modulus)
    want = _python([x for s in seeds for x in (s, s + 1)], degree, norm_bound, weight_bound,
                   modulus)
    assert np.array_equal(got.reshape(-1, degree), want)


def test_wrapper_refuses_an_empty_range():
    """The wrapper refuses randrange(0) as CPython does, before it looks at
    the device: the kernel takes a bound of at least 1 when it draws."""
    with pytest.raises(ValueError, match="empty range"):
        sample_short_poly_coeffs(Q, 4, 0, 4, 0)
    with pytest.raises(ValueError, match="empty range"):
        ss.sample_short(np.zeros(1, np.uint64), 4, 0, 4, Q, "cpu")


def test_wrapper_takes_only_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        ss.sample_short(np.zeros(2, np.uint64), 64, 52, 64, Q, "cpu")


def test_uint64_seeds_is_the_c_samplers_rule():
    """Ints s with 0 <= s and s + 1 < 2**64 (bools are ints) go up as
    uint64; anything else, one seed being enough, takes CPython's random."""
    assert ds._uint64_seeds([0, True, 2**64 - 2]).tolist() == [0, 1, 2**64 - 2]
    assert ds._uint64_seeds(range(5, 8)).dtype == np.uint64
    for bad in ([1, -1], [2**64 - 1], [2**64], [3, 2**70], [1.0], [np.int64(4)], ["5"]):
        assert ds._uint64_seeds(bad) is None, bad


@pytest.mark.parametrize("device", [None, "cpu"])
def test_sample_sk_off_the_card(device):
    """Off the card ``_sample_sk`` draws on the host, the C sampler for
    uint64 seeds and CPython for the seeds it cannot take: numpy with no
    device, an int32 tensor on a CPU device."""
    params = fusion_setup(128, 5)
    d = params.degree
    for seeds in ([3, 2**32 - 1, 2**64 - 2], [2**64 - 1, 5]):
        got = ds._sample_sk(params, seeds, device)
        if device is None:
            assert isinstance(got, np.ndarray) and got.dtype == np.int32
        else:
            assert got.device.type == "cpu" and got.dtype == torch.int32
            got = got.numpy()
        assert got.shape == (len(seeds), 2, d)
        want = _python([x for s in seeds for x in (s, s + 1)], d, params.beta_sk,
                       params.omega_sk, params.modulus)
        assert np.array_equal(got.reshape(-1, d), want)


def test_keygen_on_cpu_takes_the_samplers_tensor():
    """ring.keygen on the tensor ``_sample_sk`` gives a CPU device equals it
    on the host numpy of the same seeds."""
    from fusion_cryptography_tpu_torch.scheme import ring

    params = fusion_setup(128, 5)
    cpu = torch.device("cpu")
    a = ring.keygen(params, ds._sample_sk(params, [9, 10, 11], cpu), cpu)
    b = ring.keygen(params, torch.from_numpy(ds._sample_sk(params, [9, 10, 11])), cpu)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("degree,norm_bound,weight_bound", SHAPES)
def test_bound_counts_the_words_a_stream_draws(degree, norm_bound, weight_bound):
    """``bounds.sample_short`` takes the words a stream draws on average:
    within 3 % of the mean over 200 of CPython's streams, each getrandbits
    call one word (every draw here is at most 31 bits)."""
    from fusion_cryptography_tpu_torch import bounds

    class Counting(random.Random):
        words = 0

        def getrandbits(self, k):
            Counting.words += 1
            return super().getrandbits(k)

    num = min(degree, weight_bound)
    for s in range(200):
        r = Counting(s)
        for _ in range(num):
            r.randrange(norm_bound)
            r.randrange(2)
        if num < degree:
            for i in range(degree - 1, 0, -1):
                r.randrange(i + 1)
    words = bounds.sample_short(1, degree, norm_bound, weight_bound, Q)["words_per_stream"]
    assert abs(Counting.words / 200 - words) < 0.03 * words
