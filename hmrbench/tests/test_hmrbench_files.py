"""A cell, a traffic mix and a per-layer metric added as new files in a copy
of the benchmark are taken up with no edit to a file that exists."""
import json
import shutil

import tiny_cells

from hmrbench.lib import common

METRIC = '''"""Requests completed in the measured window (a test's metric)."""
MOVES = "bodies_per_s"
UNIT = "requests"


def read(r):
    return float(r.window["units"])
'''


def test_new_files_are_taken_up(tmp_path):
    bench = tmp_path / "hmrbench"
    shutil.copytree(common.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "traffic" / "bulk-8x2.json").write_text(json.dumps(
        dict(common.read_json(bench / "traffic" / "bulk-64x1.json"),
             images_per_request=8, samples_per_image=2)))
    (bench / "workloads" / "egohmr-ddim5-new.json").write_text(json.dumps(
        dict(common.read_json(bench / "workloads" / "egohmr-ddim5-bulk.json"),
             traffic="bulk-8x2")))
    (bench / "metrics" / "requests_done.serve.py").write_text(METRIC)
    tiny_cells.TINY["egohmr-ddim5-new"] = dict(tiny_cells.TINY["egohmr-ddim5-bulk"],
                                               images_per_request=2)
    try:
        res = tiny_cells.run("egohmr-ddim5-new", trace=1, bench=bench)
    finally:
        del tiny_cells.TINY["egohmr-ddim5-new"]
    assert res["metrics"]["requests_done.serve"]["value"] >= 1
    assert res["metrics"]["requests_done.serve"]["unit"] == "requests"
    assert all(p.read_bytes() == b for p, b in before.items())
