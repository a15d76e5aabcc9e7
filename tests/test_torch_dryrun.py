"""``dryrun`` (the JAX package's multi-chip hook, ``parallel/sharded.py:
1370-1466``): every sharded path once on tiny shapes, on the CPU here, and
the device rule: asked for ``"cuda"`` it puts its shards on the visible
cards, round-robin, and never on the CPU."""

import pytest
import torch

from levelsetfortran_tpu_torch import parallel
from levelsetfortran_tpu_torch.parallel import sharded as sh

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_dryrun_on_the_cpu(n):
    parallel.dryrun(n, device="cpu")


def test_dryrun_builds_no_cpu_mesh_for_cuda(monkeypatch):
    """With two (pretended) cards, four shards go round-robin over them;
    with none, it raises instead of falling back to the CPU."""
    seen = []

    class Stop(Exception):
        pass

    def record(shape, devices):
        seen.append((shape, [str(d) for d in devices]))
        raise Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(sh, "make_mesh", record)
    with pytest.raises(Stop):
        parallel.dryrun(4)
    assert seen == [((2, 2, 1), ["cuda:0", "cuda:1", "cuda:0", "cuda:1"])]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.dryrun(4)
