"""Helpers of the benchmark's tests: a cell's run rehearsed on the CPU at
16^3 and its result line read back."""

import json

from regbench import run as R

GRID = (16, 16, 16)


def rehearse(capsys, workload, seed=7, seconds=None, program=None):
    """Run the cell through ``regbench.run.main`` on the CPU; its exit code
    and its result line (None when it printed none). The server's window
    holds two waves of 4 at 16^3 on a loaded CPU."""
    if seconds is None:
        seconds = 15.0 if workload.endswith(".serve") else 5.0
    capsys.readouterr()
    rc = R.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                 "--trace", "0"], rehearsal={"grid": GRID}, program=program)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None)


def failing(line):
    """The compared numbers that exceed their limits."""
    return sorted(k for k, c in line["checks"].items()
                  if c["value"] is None or c["value"] > c["limit"])
