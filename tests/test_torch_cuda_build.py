"""The kernels' shared scratch (``cuda_build.scratch``), on CPU tensors:
the helper does not depend on the device, so its growth, its zeroed
buffer and its lock are checked here; the kernels that use it are held
against their plain versions from several threads in
``test_torch_kernels_gpu.py::test_shared_scratch_across_threads``."""

import threading

import pytest
import torch

from sentinel_tpu_torch.utils import cuda_build

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_scratch():
    saved = dict(cuda_build._SCRATCH)
    cuda_build._SCRATCH.clear()
    yield
    cuda_build._SCRATCH.clear()
    cuda_build._SCRATCH.update(saved)


def test_scratch_grows_by_doubling_and_keeps_its_buffer():
    with cuda_build.scratch(CPU, 7, 100) as (p1, n1, z1):
        assert n1 == 100 and z1 is None and p1 is not None
    with cuda_build.scratch(CPU, 7, 60) as (p2, n2, _):
        assert (p2, n2) == (p1, 100)  # large enough: the same bytes
    with cuda_build.scratch(CPU, 7, 150) as (_, n3, _):
        assert n3 == 200  # doubled
    with cuda_build.scratch(CPU, 7, 1000) as (_, n4, _):
        assert n4 == 1000  # more than double: what was asked
    with cuda_build.scratch(CPU, 8, 0) as (p5, n5, z5):
        assert (p5, n5, z5) == (None, 0, None)  # another stream, nothing asked


def test_scratch_zeroed_buffer_starts_zero_and_is_per_stream():
    with cuda_build.scratch(CPU, 1, 0, 64) as (p, n, z):
        assert p is None and n == 0 and z is not None
        buf = cuda_build._SCRATCH[(True, CPU, 1)]
        assert buf.numel() == 64 and not bool(buf.any())
    with cuda_build.scratch(CPU, 2, 16, 64) as (p2, _, z2):
        assert z2 != z and p2 != z2


@pytest.mark.parametrize("nbytes", [0, 32])
def test_scratch_holds_its_lock_until_the_block_ends(nbytes):
    """A second thread's call waits until the first block has ended, also
    when the first asked for no bytes."""
    order = []
    inside = threading.Event()

    def second():
        inside.wait()
        with cuda_build.scratch(CPU, 3, 16):
            order.append("second")

    t = threading.Thread(target=second)
    t.start()
    with cuda_build.scratch(CPU, 3, nbytes):
        inside.set()
        t.join(timeout=0.2)
        assert t.is_alive()  # blocked on the lock
        order.append("first")
    t.join()
    assert order == ["first", "second"]


def test_check_once_skips_the_tensors_it_checked_last_per_key():
    """``check_once`` runs the check again for new tensors and keeps one
    entry per key, so two kernels' tables never overwrite each other."""
    ran = []
    a, b = torch.zeros(3), torch.zeros(3)
    for key, tensors, tag in (("k1", (a,), "a"), ("k1", (a,), "a"), ("k2", (b,), "b"), ("k1", (a,), "a"),
                              ("k2", (b,), "b"), ("k1", (a, b), "ab"), ("k1", (b,), "b1")):
        cuda_build.check_once(key, tensors, lambda tag=tag: ran.append(tag))
    assert ran == ["a", "b", "ab", "b1"]


def test_check_once_reruns_after_a_failed_check_or_a_freed_tensor():
    """A check that raises records nothing; a tensor freed and made anew
    (perhaps at the same address) is checked again."""
    ran = []

    def bad():
        ran.append("bad")
        raise ValueError("no")

    t = torch.zeros(4)
    with pytest.raises(ValueError):
        cuda_build.check_once("k3", (t,), bad)
    cuda_build.check_once("k3", (t,), lambda: ran.append("good"))
    cuda_build.check_once("k3", (t,), lambda: ran.append("again"))
    del t
    cuda_build.check_once("k3", (torch.zeros(4),), lambda: ran.append("new"))
    assert ran == ["bad", "good", "new"]
