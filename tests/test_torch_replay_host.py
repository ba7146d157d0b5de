"""Online's replay kernel (``src/repro_torch/csrc/online_replay.cu``) run
on the host: its source compiled by g++ against ``tests/cuda_host/``, a
stand-in for the CUDA built-ins it uses (one block of OS threads, so
every phase, barrier and ticket runs, one block doing all the tiles), and
held to its plain version bit for bit (start and gap_sum) and to the
inputs' classification (each row's path and counts), on the cases the
card tests use. The card runs the same source in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; this file catches a
fault in the kernel's algorithm before the card does. Skips without
g++."""
import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.online_replay import (  # noqa: E402
    online_replay_ref, online_replay_rows_ref)
from test_torch_cuda import _replay_args, _replay_edge_args  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "online_replay.cu"


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernel's source built for the host: the launches of the two
    one-thread yardsticks become plain calls, the clock read a zero and
    the cooperative launch takes the kernel itself."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the replay kernel for the host")
    src = SOURCE.read_text()
    src = re.sub(r"<<<[^>]*>>>", "", src)
    src = re.sub(r"asm volatile\(.*\);$", "t = 0;", src, flags=re.M)
    src = src.replace("(const void*)online_replay_kernel",
                      "online_replay_kernel")
    out = tmp_path_factory.mktemp("replay_host")
    (out / "online_replay.cpp").write_text(src)
    lib = out / "libonline_replay_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-pthread", "-shared", "-fPIC", "-w",
                    f"-I{ROOT / 'tests' / 'cuda_host'}", "-o", str(lib),
                    str(out / "online_replay.cpp")], check=True,
                   capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    dll.online_replay_launch.restype = ctypes.c_int
    dll.online_replay_launch.argtypes = [ctypes.c_void_p] * 12 + \
        [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    dll.online_replay_scratch_bytes.restype = ctypes.c_longlong
    dll.online_replay_scratch_bytes.argtypes = [ctypes.c_longlong] * 2
    dll.walk_chain_launch.restype = ctypes.c_int
    dll.walk_chain_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_void_p]
    return dll


def host_replay(lib, args):
    """One launch on the host: (start, gap_sum, rows, path counts)."""
    w, b, r, gi, gv, H = (np.ascontiguousarray(t.numpy()) for t in args)
    B, n = b.shape
    ins = [w.astype(np.uint8), b, r, gi, gv, H]
    start = np.full((B, n), 7, np.uint8)
    gap_sum = np.full(B, np.nan)
    rows = np.full((B, 4), -9, np.int32)
    sync = np.zeros(4, np.uint64)
    scratch = np.full(int(lib.online_replay_scratch_bytes(B, n)) // 8 + 1,
                      -1, np.int64)
    trace = np.zeros(7, np.uint64)
    code = lib.online_replay_launch(
        *(a.ctypes.data for a in ins), start.ctypes.data, gap_sum.ctypes.data,
        rows.ctypes.data, sync.ctypes.data, scratch.ctypes.data,
        trace.ctypes.data, B, n, None)
    assert code == 0
    assert sync[0] == 0 and sync[1] == (5 if n else 0)   # barriers passed
    return start, gap_sum, rows, (int(sync[2]), int(sync[3]))


def check(lib, args):
    start, gap_sum, rows, paths = host_replay(lib, args)
    ps, pg = online_replay_ref(*args)
    np.testing.assert_array_equal(start, ps.numpy().astype(np.uint8))
    np.testing.assert_array_equal(gap_sum.view(np.int64),
                                  pg.numpy().view(np.int64))
    want = online_replay_rows_ref(*args).numpy()
    np.testing.assert_array_equal(rows, want)
    literal = int((want[:, 0] == 0).sum())
    assert paths == (len(want) - literal, literal)
    return want


@pytest.mark.parametrize("B,n", ((1, 0), (1, 1), (1, 7), (16, 1029),
                                 (1, 5000)))
@pytest.mark.parametrize("H", (0.0, 37.5))
def test_host_replay_matches_plain_bitwise(host_lib, B, n, H):
    """The card tests' random rows (ties, a third of users on a gap of
    the table): start and gap_sum bit for bit, each row's record."""
    want = check(host_lib, _replay_args(B, n, H, n + B, "cpu"))
    if H == 0.0:
        assert (want[:, 3] <= 0).all()       # nothing depends on the order


@pytest.mark.parametrize("kind", ("unsorted", "mixed16", "undecided",
                                  "w8191", "w8193", "w16385"))
def test_host_replay_paths_and_edges(host_lib, kind):
    """Both paths (an unsorted gap table takes the literal walk), a row of
    undecided users (more than one staged run of the walk), and every
    user waiting at numpy's 8,192-operand block edges."""
    want = check(host_lib, _replay_edge_args(kind, "cpu"))
    if kind == "unsorted":
        assert want[0, 0] == 0
    if kind == "mixed16":
        assert (want[0, 0], want[1, 0]) == (0, 1)
    if kind == "undecided":
        assert want[0, 3] == want[0, 1] - 1 > 2048


@pytest.mark.parametrize("H", (float("nan"), float("inf"), -1.0))
def test_host_replay_takes_the_literal_walk_without_a_threshold(host_lib,
                                                                H):
    """H not finite and >= 0: the literal walk, the same function."""
    args = list(_replay_args(2, 700, 37.5, 3, "cpu"))
    args[5] = torch.tensor([37.5, H], dtype=torch.float64)
    want = check(host_lib, tuple(args))
    assert (want[0, 0], want[1, 0]) == (1, 0)


@pytest.mark.parametrize("m", (2048, 2048 * 3 + 40))
def test_host_walk_yardstick_is_the_walk(host_lib, m):
    """The walk yardstick runs the kernel's walk step over its table of
    2,048 entries again and again: the same walk as m += (m <= T) in
    Python (it returns the end plus the m stored before the table's last
    entry)."""
    ch = 2048
    table = [(k * 37) % ch - ch // 4 for k in range(ch)]
    x, before = 0, [0] * ch
    for i in range(m):
        before[i % ch] = x
        x += x <= table[i % ch]
    out = np.zeros(2, np.int64)
    assert host_lib.walk_chain_launch(out.ctypes.data, m, None) == 0
    assert int(out[0]) == x + before[ch - 1]
