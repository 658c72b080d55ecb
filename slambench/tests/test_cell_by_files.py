"""A cell added by files and new entries alone: a copy of BENCHMARK.json
with a TUM-recipe cell beside room0's, whose metrics are entries of its
own (``<metric>.<qualifier>``, listing the new cell) read by the
existing readers, while room0's entries stay as they are; and the encode
rooflines' count of the importance fine pass, a call of its own."""

import copy
import json
import os
import shutil
import time

import pytest

from slambench import harness, yardstick as Y
from slambench.tests import tiny

CONFIG = "tum_fr1_desk"
CELL = "tum.seq"


def with_tum_cell(bench):
    """``bench`` with the TUM cell and an entry of its own for each metric
    that lists only other cells."""
    b = copy.deepcopy(bench)
    b["configs"].append({"name": CONFIG, "source": "x",
                         "file": f"slambench/configs/{CONFIG}.json",
                         "reduced": ["data"], "why": "x"})
    b["workloads"].append({"name": CELL, "config": CONFIG, "traffic": "seq",
                           "chips": 1, "why": "x"})
    for group in ("end_to_end", "per_layer"):
        for m in list(b[group]):
            if "workloads" in m:
                b[group].append(dict(m, name=m["name"] + ".tum",
                                     workloads=[CELL]))
    return b


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """The benchmark's files, with the TUM cell's configuration, limits
    (room0's) and entries added."""
    root = tmp_path_factory.mktemp("cell_by_files")
    shutil.copytree(os.path.join(harness.ROOT, "slambench"),
                    root / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "slambench" / "limits" / "replica_room0.json",
                root / "slambench" / "limits" / f"{CONFIG}.json")
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(with_tum_cell(bench), f)
    return str(root), bench


def test_old_entries_unchanged_and_the_new_cell_reports_its_own(checkout):
    root, bench = checkout
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        grown = json.load(f)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert grown[group][:len(bench[group])] == bench[group]
    room0 = harness.cell_spec(root, "room0.seq")
    old = harness.cell_spec(harness.ROOT, "room0.seq")
    for kind in ("end_to_end", "per_layer"):
        assert room0[kind] == old[kind]
    tum = harness.cell_spec(root, CELL)
    assert {m["name"] for m in tum["end_to_end"]} == {
        "fps", "setup_s", "frame_ms_p95.tum"}
    assert {m["name"] for m in tum["per_layer"]} == {
        m["name"] + ".tum" for m in bench["per_layer"]}
    for m in tum["end_to_end"] + tum["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_a_qualified_name_is_read_by_its_base_reader():
    assert (harness.reader("ba_ms.p95.tum").__code__.co_filename
            == harness.reader("ba_ms.p95").__code__.co_filename)
    assert harness.reader("track_ms.x.y").__code__.co_filename.endswith(
        os.path.join("metrics", "track_ms.py"))
    with pytest.raises(FileNotFoundError, match=r"metrics[/\\]nosuch\.py"):
        harness.reader("nosuch.tum")


def _traced_tiny_tum(root, device):
    spec = harness.cell_spec(root, CELL)
    r = harness.run_cell(CELL, 5, 4.0, True, time.perf_counter(),
                         device=device, root=root,
                         overrides=tiny.overrides(CONFIG),
                         traffic_overrides=tiny.TRAFFIC,
                         sequence_overrides=tiny.SEQUENCE, spec=spec)
    assert r["correct"], r["checks"]
    return r, {m["name"] for m in spec["per_layer"]}


ROOFLINES = {"kernA_roofline.tum", "kernB_roofline.tum"}


def test_traced_tiny_tum_cell_reports_its_per_layer_metrics(checkout):
    """The new cell's own entries, from its spec in the copied
    BENCHMARK.json, in a traced run of the tiny TUM cell on the CPU: all
    but the encode kernels' rooflines, which read the card's kernels."""
    r, names = _traced_tiny_tum(checkout[0], "cpu")
    assert set(r["metrics"]) == names - ROOFLINES


@pytest.mark.cuda
def test_traced_tiny_tum_cell_reports_every_per_layer_metric(checkout,
                                                             cuda_device):
    """The same on the card, the encode rooflines with the fine pass's
    calls counted apart: every metric, each share under 100 %."""
    r, names = _traced_tiny_tum(checkout[0], "cuda")
    assert set(r["metrics"]) == names
    for name in ROOFLINES:
        assert 0 < r["metrics"][name]["value"] < 100


def test_the_fine_pass_is_an_encode_call_of_its_own():
    cfg = harness.load_json(os.path.join(
        harness.ROOT, "slambench", "configs", f"{CONFIG}.json"))["config"]
    coarse, fine = 1024 * (64 + 21), 1024 * 128
    assert Y.frame_encode_calls(cfg, 1) == [
        ("fwd", coarse), ("bwd", coarse, False, True),
        ("fwd", fine), ("bwd", fine, False, True)] * 10
    # BA on frame 10: two keyframes, 2048 sampled rays and the current
    # frame's 1024 (half the sample), then the 63^3 lattice.
    ba = Y.frame_encode_calls(cfg, 10)[40:]
    nb = Y.ba_rays(cfg, 2)
    assert nb == 2048 + 1024
    assert ba == [("fwd", nb * 85), ("bwd", nb * 85, True, True),
                  ("fwd", nb * 128), ("bwd", nb * 128, True, True),
                  ("fwd", 63 ** 3), ("bwd", 63 ** 3, True, False)] * 20
