"""The traffic generator's data: distinct inputs for every registration of
a pool, open-loop arrivals that every seed shares, and a server mix driven
by those arrivals through the whole run."""

import numpy as np
import pytest

from _cpu import rehearse
from regbench import generator


def test_every_registration_of_a_pool_has_inputs_of_its_own():
    mix = generator.load("solve-closed-1")
    mix["pool"] = dict(mix["pool"], registrations=9)
    pairs = generator.pool(mix, (16, 16, 16), 4, seed=2**31 + 5, dev="cpu")
    assert len(pairs) == 9
    for i in range(9):
        for j in range(i):
            assert not np.array_equal(pairs[i].m1, pairs[j].m1)
    # the base pairs in turn, each under another shift: the same images
    for i in range(4, 9):
        a, b = pairs[i].m0, pairs[i - 4].m0
        assert np.isclose(np.sort(a, axis=None), np.sort(b, axis=None)).all()


def test_arrivals_are_the_mixs_own_on_every_seed():
    mix = dict(generator.load("serve-cohort-8"),
               arrivals={"kind": "poisson", "rate_per_s": 4.0, "seed": 17})
    t = generator.arrivals(mix, 30.0)
    assert t == generator.arrivals(mix, 30.0)
    assert all(0 < a < b < 30.0 for a, b in zip(t, t[1:]))
    assert 80 <= len(t) <= 160
    assert generator.arrivals(generator.load("serve-cohort-8"), 30.0) is None
    with pytest.raises(ValueError):
        generator.arrivals(dict(mix, arrivals={"kind": "bursty"}), 30.0)


def test_an_open_loop_server_mix_runs_and_is_correct(capsys, monkeypatch):
    orig = generator.load

    def load(mix):
        d = orig(mix)
        if d["entry"] == "server":
            d["arrivals"] = {"kind": "poisson", "rate_per_s": 2.0, "seed": 5}
        return d

    monkeypatch.setattr(generator, "load", load)
    rc, line = rehearse(capsys, "claire256-fp32.serve", seconds=6.0,
                        program={"solver": {"max_newton": 8}})
    assert rc == 0 and line["correct"] is True, line
    assert line["attempted"] == len(generator.arrivals(load("serve-cohort-8"), 6.0))
