"""The sharded engines' plan link (``serving/sharded.py`` ``_Link``)
closes in seconds when its heartbeat reaches the link's lock just as the
last endpoint closes, and no beat reaches the followers after the
``close`` plan.

A 2-rank gloo world (``tests/torch_dist_worker.py``'s ``planlink``
suite) with a link timeout of 2 s, so a beat every 0.25 s. The driver's
beat thread is held at the lock's acquire, past its wait, and the lock
opens for it only once the close went out: the interleaving that left a
beat broadcasting to followers whose dispatchers had returned on the
close, a gloo broadcast that waits out the group's timeout."""
import pytest

import torch_dist_worker as W

TIMEOUT = 120.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World("planlink", 2, tmp_path_factory.mktemp("torch_plan_link"),
                TIMEOUT)
    yield w
    w.close()


def test_close_with_beat_held_at_lock_sends_no_beat_after_close(world):
    driver, follower = world.case("close-after-beat")
    # the close returns in seconds, and its beat thread has ended
    assert driver["close_s"] < W.LINK_TIMEOUT_S / 2, driver
    assert not driver["beat_alive"]
    # the follower's dispatcher ended on the close; nothing came after it
    assert not follower["dispatcher_alive"]
    assert follower["plans"] == []
    assert follower["after_close"] is None, follower


def test_plan_link_world_imports_no_jax(world):
    assert world.results()["_jax_imported"] == []
