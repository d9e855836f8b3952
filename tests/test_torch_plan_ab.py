"""tools/plan_ab: the page plans' host build A/B across source trees,
on the CPU at a small scale."""

import json
import sys
from pathlib import Path

import pytest

from lux_tpu_torch.tools import plan_ab

REPO = Path(__file__).resolve().parent.parent


def test_plan_ab_takes_named_trees():
    """A tree not given as NAME=DIR is a usage error before any process
    starts."""
    for argv in ([], ["--tree", "no_name"]):
        with pytest.raises(SystemExit) as e:
            plan_ab.main(argv)
        assert e.value.code == 2


@pytest.mark.skipif(not sys.platform.startswith("linux"),
                    reason="reads /proc/self/status")
def test_plan_ab_builds_every_plan_in_turns(capsys):
    """Two trees (this checkout twice) in turns: every plan built in
    every run, the same arrays each time, its peak bytes over the
    graph's never negative."""
    assert plan_ab.main(["--tree", f"a={REPO}", "--tree", f"b={REPO}",
                         "--scale", "10", "--parts", "3"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["parts"] == 3 and lines[0]["cpus"] >= 1
    runs = [r for ln in lines[1:] for r in ln["runs"]]
    assert [ln["tree"] for ln in lines[1:]] == ["a", "b"] and len(runs) == 4
    for name in plan_ab.PLANS:
        assert len({json.dumps(r[name]["checksum"]) for r in runs}) == 1
        assert all(r[name]["seconds"] > 0 and r[name]["Rp"] > 0
                   and r[name]["peak_bytes_over_graph"] >= 0 for r in runs)
