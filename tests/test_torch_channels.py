"""The port's in-process channels against the reference's.

``repro_torch.workflow.channels`` is a copy of ``repro.workflow.channels``:
the same seed must give the same per-endpoint random stream, so a channel
with injected drops and delays loses and delivers exactly the messages the
reference's loses and delivers, and the registry counts, closes and serves
the generated bundles' protocol as the reference's does.  The reference's
own channel tests (``tests/test_channels.py``) run here on the port's
classes too.
"""

from __future__ import annotations

import threading
import time

import pytest

from repro.workflow import channels as jch
from repro_torch.workflow import channels as tch

ENDPOINTS = [("l0", "l1", "p0"), ("a", "b", "p"), ("x", "y", "z#b3.17"), ("l^d", "l^IM", "dIM")]
SEEDS = [0, 1, 7, 12345]


@pytest.mark.parametrize("seed", SEEDS)
def test_endpoint_rng_gives_the_references_sequences(seed):
    for ep in ENDPOINTS:
        want = jch.endpoint_rng(seed, ep)
        got = tch.endpoint_rng(seed, ep)
        assert [got.random() for _ in range(64)] == [want.random() for _ in range(64)]


@pytest.mark.parametrize("drop_prob", [0.0, 0.3, 0.7])
@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_drops_deliver_what_the_references_deliver(seed, drop_prob):
    for ep in ENDPOINTS:
        j = jch.Channel(ep, drop_prob=drop_prob, seed=seed)
        t = tch.Channel(ep, drop_prob=drop_prob, seed=seed)
        accepted = [(t.put(f"d{i}", i), j.put(f"d{i}", i)) for i in range(40)]
        assert [a for a, _ in accepted] == [b for _, b in accepted]
        assert (t.sent, t.dropped) == (j.sent, j.dropped)
        got = [(m.data_name, m.payload, m.seq) for m in (t.get(timeout=1.0) for _ in range(t.sent - t.dropped))]
        want = [(m.data_name, m.payload, m.seq) for m in (j.get(timeout=1.0) for _ in range(j.sent - j.dropped))]
        assert got == want
        with pytest.raises(TimeoutError):
            t.get(timeout=0.01)


def test_delay_and_reliable_put_match_the_reference():
    ep = ("l0", "l1", "p")
    j = jch.Channel(ep, drop_prob=0.5, delay_s=0.002, seed=3)
    t = tch.Channel(ep, drop_prob=0.5, delay_s=0.002, seed=3)
    t0 = time.monotonic()
    for i in range(10):
        t.put_reliable(f"d{i}", i)
        j.put_reliable(f"d{i}", i)
    assert time.monotonic() - t0 >= 2 * 10 * 0.002  # every accepted put slept
    assert (t.sent, t.dropped) == (j.sent, j.dropped) and t.dropped > 0
    assert [t.get(timeout=1.0).payload for _ in range(10)] == list(range(10))
    # A wire that drops everything exhausts the retries with the reference's error.
    dead = tch.Channel(ep, drop_prob=1.0)
    with pytest.raises(tch.ChannelClosed, match="dropped the message 20 times"):
        dead.put_reliable("d", 1)


def test_registry_behaves_as_the_references():
    j = jch.ChannelRegistry(seed=5, drop_prob=0.4)
    t = tch.ChannelRegistry(seed=5, drop_prob=0.4)
    for reg in (j, t):
        for i in range(3):
            ch = reg.channel("src", f"dst{i}", "p")
            assert ch is reg.channel("src", f"dst{i}", "p")  # lazily made once
            for k in range(16):
                ch.put(f"d{k}", k)
    assert t.stats() == j.stats()
    # The generated bundles' protocol: put((name, payload)) / get().
    view = t[("src", "dst9", "q")]
    view.put(("d", 42))
    assert view.get() == ("d", 42)
    # close() wakes a blocked receiver, and later channels are born closed.
    caught = []
    ch = t.channel("src", "dst0", "blocked")

    def receiver():
        try:
            ch.get(timeout=10.0)
        except tch.ChannelClosed as e:
            caught.append(e)

    th = threading.Thread(target=receiver, daemon=True)
    th.start()
    time.sleep(0.05)
    t.close()
    th.join(5.0)
    assert not th.is_alive() and caught
    with pytest.raises(tch.ChannelClosed):
        t.channel("late", "comer", "p").put("d", 1)


def test_pending_messages_drain_before_closed_raises():
    ch = tch.Channel(("a", "b", "p"))
    ch.put("d0", 0)
    ch.close()
    assert ch.get(timeout=1.0).payload == 0
    with pytest.raises(tch.ChannelClosed):
        ch.get(timeout=1.0)


# -- the reference's own channel tests, on the port's classes -----------------------


def _pattern(ch, n: int = 64) -> list[bool]:
    return [ch._rng.random() < 0.5 for _ in range(n)]


def test_endpoints_in_one_registry_are_decorrelated():
    reg = tch.ChannelRegistry(seed=0, drop_prob=0.5)
    pats = [_pattern(reg.channel("l0", f"l{i}", f"p{i}")) for i in range(1, 5)]
    assert len({tuple(p) for p in pats}) == len(pats)


def test_same_seed_reproduces_same_faults():
    p1 = _pattern(tch.ChannelRegistry(seed=3).channel("a", "b", "p"))
    p2 = _pattern(tch.ChannelRegistry(seed=3).channel("a", "b", "p"))
    assert p1 == p2


def test_registry_seed_changes_every_stream():
    p1 = _pattern(tch.ChannelRegistry(seed=0).channel("a", "b", "p"))
    p2 = _pattern(tch.ChannelRegistry(seed=1).channel("a", "b", "p"))
    assert p1 != p2


def test_endpoint_rng_mixes_all_triple_components():
    base = tch.endpoint_rng(0, ("a", "b", "p")).random()
    assert base != tch.endpoint_rng(0, ("x", "b", "p")).random()
    assert base != tch.endpoint_rng(0, ("a", "x", "p")).random()
    assert base != tch.endpoint_rng(0, ("a", "b", "x")).random()


def test_dropped_messages_differ_across_channels():
    reg = tch.ChannelRegistry(seed=0, drop_prob=0.5)
    outcomes = {}
    for i in range(4):
        ch = reg.channel("src", f"dst{i}", "p")
        outcomes[i] = tuple(ch.put(f"d{j}", j) for j in range(32))
    assert len(set(outcomes.values())) > 1
