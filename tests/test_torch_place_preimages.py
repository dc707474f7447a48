"""The prehash sponge's input placed from a flat message stream
(``ops/place_preimages.py``, kernel ``csrc/place_preimages.cu``), and the
packing counters.

The plain placement is held word for word, block counts and lengths
included, against the route the port took before: the JAX package's
``msg_preimage_words`` rows, permuted to signer-major lanes, transposed,
zero-padded to whole rate blocks and padded by ``keccak.pad_words(...,
0x06)``.  The kernel's per-word function, compiled for the host CPU with a
serial loop over the lanes and words in place of the grid, is held against
the plain placement on the same stream.  The launch itself runs only on the
card (``tests/test_torch_cuda_kernels.py``, marked ``cuda``, and
``chip_smoke.py``).  The one-pass buffer made from the ``str`` objects
(``csrc/pack_messages.c``) is held byte for byte against
``stream_buffer(*encode(...))``, its copy split over any number of
threads."""
import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu.scheme.device_pipeline import msg_preimage_words as j_words
from fusion_cryptography_tpu_torch import fusion_setup
from fusion_cryptography_tpu_torch.ops import keccak
from fusion_cryptography_tpu_torch.ops import place_preimages as pp
from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
from fusion_cryptography_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parents[1] / "fusion_cryptography_tpu_torch" / "csrc"
CPU = torch.device("cpu")
PREFIX = 3  # dst + ","


def _text(seed: int, n: int) -> str:
    return np.random.default_rng(seed).integers(0x20, 0x7F, n, dtype=np.uint8).tobytes().decode()


# message sets; each holds a multiple of 4 messages (groups of N = 4)
CASES = {
    "empty": [""] * 4,
    "one_byte": [_text(1, 1), "a", "~", " "],
    # preimages of 135, 136, 137 and 272 bytes: around the rate's edges
    "rate_edges": [_text(2, n - PREFIX) for n in (135, 136, 137, 272)],
    # the nist traffic's 33 * k bytes, k = 1..100
    "nist": [_text(3 + k, 33 * k) for k in range(1, 101)],
    # multi-byte UTF-8 in one message: the chunk leaves the bulk path
    "non_ascii": ["ascii", "é" * 70, "\U0001F600 ü", _text(4, 131)] * 2,
    "nul": ["\x00", "a\x00b", "\x00" * 134, _text(5, 40) + "\x00"],
}


@pytest.fixture(scope="module")
def params():
    return fusion_setup(256, 3), ftpu.fusion_setup(256, 3)


def _todays_route(jp, msgs, n_signers):
    """The JAX package's rows, permuted to signer-major lanes, transposed,
    zero-padded to whole rate blocks, padded with the SHA3 domain byte ->
    (words int32[rows, B], block counts, lengths)."""
    rows, lens = j_words(jp, msgs)
    B, c = len(msgs), len(msgs) // n_signers
    mw = torch.from_numpy(rows.view(np.int32)).reshape(c, n_signers, -1).transpose(0, 1)
    ml = torch.from_numpy(lens).reshape(c, n_signers).t().reshape(-1)
    t = mw.reshape(B, -1).t()
    pad = dp._pad_rate(t.shape[0] * 4) // 4 - t.shape[0]
    t = torch.nn.functional.pad(t, (0, 0, 0, pad)).contiguous()
    words, n_blocks = keccak.pad_words(t, ml, 0x06)
    return words, n_blocks, ml


def _placed(tp, msgs, n_signers):
    return dp._message_tensors(tp, msgs, CPU, n_signers)


@pytest.mark.parametrize("n_signers", [1, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_placement_equals_todays_route(params, case, n_signers):
    tp, jp = params
    msgs = CASES[case]
    words, n_blocks, lengths = _placed(tp, msgs, n_signers)
    want_w, want_nb, want_len = _todays_route(jp, msgs, n_signers)
    rows = words.shape[0]
    assert words.shape == (rows, len(msgs)) and rows % keccak.RATE_WORDS == 0
    assert rows == (PREFIX + max(len(m.encode()) for m in msgs)) // keccak.RATE * 34 + 34
    assert torch.equal(words, want_w[:rows])
    assert not want_w[rows:].any()  # today's rows past the tight ones are zero
    assert torch.equal(n_blocks, want_nb)
    assert torch.equal(lengths, want_len)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("place_host")
    src = out / "place_loops.cpp"
    src.write_text(r"""
#include "place_preimages.cu"

// Every lane and every word of it, as the grid's threads write them.
extern "C" void host_place_preimages(const uint8_t* prefix, int prefix_len,
                                     const int64_t* offsets, const uint32_t* stream,
                                     int64_t lanes, int n, int rows, int32_t* words,
                                     int32_t* n_blocks, int32_t* lengths) {
  for (int64_t lane = 0; lane < lanes; ++lane) {
    const PlaceLane p = place_lane(offsets, lane, lanes, n, prefix_len);
    n_blocks[lane] = (int32_t)((p.last + 1) / kPlaceRate);
    lengths[lane] = (int32_t)p.len;
    for (int r = 0; r < rows; ++r)
      words[(int64_t)r * lanes + lane] = (int32_t)place_word(prefix, prefix_len, stream, p, r);
  }
}
""")
    so = out / "libplace_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.host_place_preimages.argtypes = [P, I32, P, P, I64, I32, I32, P, P, P]
    lib.host_place_preimages.restype = None
    return lib


@pytest.mark.parametrize("n_signers", [1, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_words_equal_plain(host_lib, params, case, n_signers):
    """The kernel's lanes, on outputs filled with -1, against the plain
    placement of the same stream."""
    tp, _ = params
    msgs = CASES[case]
    data, lens, _ = pp.encode(msgs)
    buf = pp.stream_buffer(data, lens, pin=False)
    offsets, stream = pp.split(buf, len(msgs))
    prefix = torch.tensor(list(bytes(tp.sign_pre_hash_dst) + b","), dtype=torch.uint8)
    rows = pp.rows_for(PREFIX + int(lens.max()))
    want = pp.place_preimages_plain(prefix, offsets, stream, n_signers, rows)
    B = len(msgs)
    got = (torch.full((rows, B), -1, dtype=torch.int32), torch.full((B,), -1, dtype=torch.int32),
           torch.full((B,), -1, dtype=torch.int32))
    host_lib.host_place_preimages(prefix.data_ptr(), PREFIX, offsets.data_ptr(),
                                  stream.data_ptr(), B, n_signers, rows,
                                  *(t.data_ptr() for t in got))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", list(CASES))
def test_pack_counters(params, case):
    """``pack.payload_bytes`` counts the message bytes, ``pack.shipped_bytes``
    the uploaded stream's (whole words, one past the last byte),
    ``pack.rows_direct`` the messages copied straight from their ``str``:
    all of an ASCII chunk, else none, and ``pack.rows_fallback`` the
    messages encoded one by one: all of a chunk that holds a non-ASCII
    message, else none."""
    tp, _ = params
    msgs = CASES[case]
    payload = sum(len(m.encode("utf-8")) for m in msgs)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        _, _, lengths = _placed(tp, msgs, 4)
    assert profiling.counters() == {
        "pack.payload_bytes": payload,
        "pack.shipped_bytes": 4 * (payload // 4 + 1),
        "pack.rows_direct": 0 if case == "non_ascii" else len(msgs),
        "pack.rows_fallback": len(msgs) if case == "non_ascii" else 0}
    assert int(lengths.sum()) == payload + PREFIX * len(msgs)
    profiling.reset_counters()


@pytest.mark.parametrize("msgs", [["ok", "\ud800"], ["\ud800"]], ids=["second", "only"])
def test_unencodable_message_raises(params, msgs):
    """A message UTF-8 cannot encode (a lone surrogate) raises as
    ``str.encode`` does, whichever messages share its chunk."""
    with pytest.raises(UnicodeEncodeError):
        _placed(params[0], msgs, 1)


def test_lanes_must_fill_the_groups(params):
    data, lens, _ = pp.encode(["a", "b", "c"])
    offsets, stream = pp.split(pp.stream_buffer(data, lens, pin=False), 3)
    with pytest.raises(ValueError, match="signers a group"):
        pp.place_preimages(torch.zeros(3, dtype=torch.uint8), offsets, stream, 2, 34)


def _plain_buffer(msgs):
    data, lens, _ = pp.encode(msgs)
    return pp.stream_buffer(data, lens, pin=False)


@pytest.mark.parametrize("n_signers", [1, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_direct_buffer_equals_plain(params, case, n_signers, monkeypatch):
    """The buffer copied straight from the ``str`` objects equals
    ``stream_buffer(*encode(msgs))`` byte for byte (offsets and zero tail
    included), and ``_message_tensors`` places the same words, block counts
    and lengths from it as from the plain route; a chunk with a non-ASCII
    message takes the plain route."""
    msgs = CASES[case]
    direct = pp.direct_offsets(msgs)
    if case == "non_ascii":
        assert direct is None
    else:
        offsets, longest = direct
        assert longest == max(map(len, msgs))
        assert torch.equal(pp.direct_buffer(msgs, offsets, pin=False), _plain_buffer(msgs))
    got = _placed(params[0], msgs, n_signers)
    monkeypatch.setattr(pp, "direct_offsets", lambda messages: None)
    want = _placed(params[0], msgs, n_signers)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("threads", [1, 2, 3, 7, 64])
def test_direct_copy_split_over_threads(threads):
    """The copy, made by one thread as it walks the list or split into
    ``threads`` byte ranges (shares that start and end inside messages, and
    empty messages), gives the plain buffer, whatever the block held
    before."""
    g = random.Random(threads)
    msgs = [_text(g.randrange(1 << 30), g.choice([0, 1, 33, 700, 3300])) for _ in range(257)]
    offsets, _ = pp.direct_offsets(msgs)
    want = _plain_buffer(msgs)
    got = torch.full_like(want, 0xAB)
    assert pp._library().fct_pack_fill(msgs, offsets.ctypes.data, len(msgs), got.data_ptr(),
                                       got.numel(), threads) == 0
    assert torch.equal(got, want)


def test_direct_buffer_above_the_thread_threshold():
    """A chunk of more than two threads' payload (the threads it gets depend
    on the cores) against the plain buffer."""
    msgs = [_text(k, 3300) for k in range(8)] * (2 * pp.BYTES_A_THREAD // (8 * 3300) + 9)
    offsets, _ = pp.direct_offsets(msgs)
    assert offsets[-1] > 2 * pp.BYTES_A_THREAD
    assert torch.equal(pp.direct_buffer(msgs, offsets, pin=False), _plain_buffer(msgs))


def test_direct_buffer_refuses_changed_messages():
    """Offsets that no longer match the list (a message replaced by a longer
    one, one taken away) raise."""
    msgs = ["ab", "cd", "ef", "gh"]
    offsets, _ = pp.direct_offsets(msgs)
    for changed in (["ab", "cde", "ef", "gh"], msgs[:3]):
        with pytest.raises(RuntimeError, match="changed"):
            pp.direct_buffer(changed, offsets, pin=False)


@pytest.mark.parametrize("kind", ["tuple", "int", "bytes", "none"])
def test_other_inputs_take_the_plain_route(params, kind):
    """A tuple of messages places what the list does through the plain
    route (no row copied straight); a list holding a non-``str`` item raises
    the ``TypeError`` that ``encode`` raises."""
    msgs = CASES["rate_edges"]
    if kind == "tuple":
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU]):
            got = _placed(params[0], tuple(msgs), 4)
        assert profiling.counters()["pack.rows_direct"] == 0
        profiling.reset_counters()
        for g, w in zip(got, _placed(params[0], msgs, 4)):
            assert torch.equal(g, w)
        return
    bad = list(msgs)
    bad[2] = {"int": 7, "bytes": b"abc", "none": None}[kind]
    assert pp.direct_offsets(bad) is None
    with pytest.raises(TypeError) as plain:
        pp.encode(bad)
    with pytest.raises(TypeError) as placed:
        _placed(params[0], bad, 4)
    assert str(placed.value) == str(plain.value)
