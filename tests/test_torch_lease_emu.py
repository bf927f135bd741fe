"""The batched delayed lease kernel on host threads (``tools/sm90_emu.py
--lease``), on the CPU.

g++ builds ``lease_array/csrc/lease_window.cu`` for A 3 against the
emulated CUDA surface of ``tools/sm90_emu/emu_cuda.h`` (a block's threads
as ``std::thread``s, warp shuffles, votes and barriers); the port's own
wrapper ``lease_window_delayed_batched`` then launches it on CPU tensors,
and two small batches of ``chip_smoke.lane_case`` (13 cells, ragged about
every tile; four cells, quiet enough for the quiescence skip to take
windows) are held bit-exact against ``lease_window_delayed_batched_torch``
in every plane-group variant at every lane count, both collect modes,
windows 1 and 16, the skip on and off. Without g++ it skips. The whole set of cases, A 3
and 5, runs as ``python3 tools/sm90_emu.py --lease`` (a few minutes).
"""
import importlib.util
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def emu():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host-thread emulation of the lease kernels")
    spec = importlib.util.spec_from_file_location("sm90_emu", ROOT / "tools" / "sm90_emu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path.insert(0, str(ROOT))
    from repro_torch.lease_array import _build

    return mod, {3: mod.load_lease(_build.CSRC, 3)}


#: (A, N, B, T, quiet), as chip_smoke.LANE_CASES
CASES = [(3, 13, 2, 16, False), (3, 4, 3, 24, True)]


@pytest.mark.parametrize("case", CASES)
def test_batched_delayed_kernel_on_host_threads_equals_plain(emu, case):
    mod, libs = emu
    assert mod.run_case_lease(libs, *case)
