"""eval/smoke_compare.py on a stand-in checkout: what it records.

The driver needs a CUDA device; here torch.cuda's memory queries are
stubbed with fixed numbers and the checkout's chip_smoke.py is a stand-in
with one phase that empties the cache and starts a subprocess, so that the
records' shape, their order and the import of the chosen checkout (not
this one) are checked without a card.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from torch_port_util import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
DRIVER = ROOT / "geoformer_tpu_torch" / "eval" / "smoke_compare.py"

STAND_IN = '''
import subprocess, sys, torch
def phase_device():
    return "stand-in card"
def phase_work(device):
    torch.cuda.empty_cache()
    subprocess.run([sys.executable, "-c", "pass"], check=True)
def phase_main_path(device):
    return {}, 12.5, None
def main():
    phase_device()
    phase_work(None)
    print('{"ok": true}')
    return 0
'''

# 1.5 GiB reserved and allocated, 1 of 2 GiB free on the card
STUBS = '''
import runpy, sys, torch
c = torch.cuda
c.is_available = c.is_initialized = lambda: True
c.mem_get_info = lambda: (1 << 30, 2 << 30)
c.memory_reserved = c.memory_allocated = lambda: 3 << 29
c.max_memory_allocated = c.max_memory_reserved = lambda: 3 << 29
c.reset_peak_memory_stats = c.synchronize = c.empty_cache = lambda: None
sys.argv = [sys.argv[1]] + sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
'''


def _run(tmp_path, *args):
    root = tmp_path / "checkout"
    (root / "geoformer_tpu_torch").mkdir(parents=True)
    (root / "geoformer_tpu_torch" / "__init__.py").write_text("")
    (root / "chip_smoke.py").write_text(STAND_IN)
    stubs = tmp_path / "stubs.py"
    stubs.write_text(STUBS)
    r = subprocess.run([sys.executable, str(stubs), str(DRIVER),
                        "--root", str(root), "--label", "old", *args],
                       capture_output=True, text=True, timeout=120,
                       cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    recs = [json.loads(ln.split(" ", 1)[1]) for ln in lines
            if ln.startswith("[smoke_compare] ")]
    return recs, lines


def test_full_mode_records_phases_subprocesses_and_cache_drops(tmp_path):
    recs, lines = _run(tmp_path, "--mode", "full")
    mem = {"reserved_gib": 1.5, "allocated_gib": 1.5, "card_free_gib": 1.0}
    assert [r.get("phase") or r["event"] for r in recs] == [
        "phase_device", "empty_cache", "subprocess", "phase_work"]
    assert all(r["label"] == "old" for r in recs)
    drop, sub, phase = recs[1], recs[2], recs[3]
    assert drop["at"][0] == "phase_work" and drop["before"] == mem
    assert sub["at"][0] == "phase_work" and sub["cmd"].endswith("-c pass")
    assert {k: sub[k] for k in mem} == mem
    assert phase["entry"] == phase["exit"] == mem
    assert phase["peak_allocated_gib"] == phase["peak_reserved_gib"] == 1.5
    assert lines[-1] == '{"ok": true}'


def test_main_path_mode_reports_each_run(tmp_path):
    recs, _ = _run(tmp_path, "--mode", "main_path", "--repeat", "2")
    assert [(r["run"], r["ms_per_pair"], r["card"]) for r in recs] == [
        (0, 12.5, "stand-in card"), (1, 12.5, "stand-in card")]
