"""``chip_smoke.py``'s lanes: the gang phases run at once, one thread a
lane, and their printed lines must stay whole, every lane must run to its
end, and a lane's failure must be raised once all have ended.  Runs on the
CPU with lanes that only print and sleep."""

import sys
import time

import pytest

import chip_smoke


def _lane(name, n, fail=False, done=None):
    def run():
        for i in range(n):
            # Two writes a line, as print() makes them, with a switch
            # between: the router must not let another lane's text in.
            sys.stdout.write(f"{name} line {i} " + "x" * 40)
            time.sleep(0.001)
            sys.stdout.write("\n")
        if done is not None:
            done.append(name)
        if fail:
            raise AssertionError(f"{name}: failed")
        return name.upper()
    return run


def test_lanes_keep_lines_whole_and_return_results(capsys):
    got = chip_smoke._run_lanes({n: _lane(n, 50) for n in ("a", "b", "c")})
    assert got == {"a": "A", "b": "B", "c": "C"}
    out = capsys.readouterr().out.splitlines()
    body = [ln for ln in out if not ln.startswith("lanes: ")]
    assert len(body) == 150
    assert all(ln.split()[1:3] == ["line", ln.split()[2]]
               and ln.endswith("x" * 40) and ln.count("line") == 1
               for ln in body)
    for n in ("a", "b", "c"):
        assert [ln for ln in body if ln.startswith(n + " ")] == \
            [f"{n} line {i} " + "x" * 40 for i in range(50)]
    assert out[-1].startswith("lanes: a ") and "at once" in out[-1]
    assert sys.stdout is not None and \
        not isinstance(sys.stdout, chip_smoke._LineRouter)


def test_lane_failure_raised_after_every_lane_ended(capsys):
    done = []
    with pytest.raises(AssertionError, match="b: failed"):
        chip_smoke._run_lanes({"a": _lane("a", 30, done=done),
                               "b": _lane("b", 1, fail=True, done=done),
                               "c": _lane("c", 30, done=done)})
    assert sorted(done) == ["a", "b", "c"]
    out = capsys.readouterr().out
    assert "lanes: the b lane failed" in out
    assert not isinstance(sys.stdout, chip_smoke._LineRouter)

