"""The rank launcher's report of a failure (``radioframe_torch/shard/mesh.py``
``_collect``): a rank that raises tears its process group down, which fails
the other ranks' pending collectives, so their reports can reach the parent
before the one that caused them. The call must still name the rank that
failed first, whatever order the reports arrive in."""

import queue

import pytest

from radioframe_torch.shard.mesh import _collect


class _Proc:
    exitcode = None


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_collect_reports_every_failure_whatever_their_order(order):
    reports = {0: (0, False, "RuntimeError: Connection closed by peer"),
               1: (1, False, "ValueError: rank 1 was told to fail")}
    q = queue.Queue()
    for r in order:
        q.put(reports[r])
    with pytest.raises(RuntimeError) as err:
        _collect([_Proc(), _Proc()], q, timeout_s=60.0)
    msg = str(err.value)
    assert "rank 1 failed:\nValueError: rank 1 was told to fail" in msg
    assert "rank 0 failed:\nRuntimeError: Connection closed" in msg
    assert msg.index(f"rank {order[0]} failed") < msg.index(f"rank {order[1]} failed")
