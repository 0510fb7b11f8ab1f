"""The port's examples (``examples/torch_*.py``) on the CPU.

* ``torch_photonic_sim.py`` prints exactly the lines of the reference's
  ``examples/photonic_sim.py`` (``benchmarks/table1_scalability.run`` and
  ``benchmarks/fig5_fps.run``, imported from the repo root).
* Every torch example runs with ``--device cpu`` at its own small size and
  finishes (each carries its own self-checks): ``torch_quickstart.py``,
  ``torch_api_quickstart.py``, ``torch_serve_lm.py --smoke`` (a decoder and
  an encoder-decoder arch), ``torch_train_lm.py --smoke``,
  ``torch_quantize_model.py``.  They run in this process (``runpy``), on
  one torch thread.  None is too slow for tier-1; on the card
  ``chip_smoke.py`` phase 15 runs ``torch_quickstart.py`` and
  ``torch_photonic_sim.py`` as subprocesses.

About 20 s in one process (``torch_train_lm.py --smoke`` 11 s of it).
"""

import runpy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

CPU_RUNS = {
    "quickstart": ("torch_quickstart.py", ["--device", "cpu"], "quickstart OK"),
    "api_quickstart": ("torch_api_quickstart.py", ["--device", "cpu"], "6. batched admission"),
    "serve_lm": ("torch_serve_lm.py", ["--smoke", "--device", "cpu"], "[serve_lm] llama3.2-1b"),
    "serve_lm_encdec": ("torch_serve_lm.py", ["--smoke", "--device", "cpu", "--arch",
                                              "seamless-m4t-large-v2", "--gen", "4"],
                        "[serve_lm] seamless-m4t-large-v2"),
    "train_lm": ("torch_train_lm.py", ["--smoke", "--device", "cpu"],
                 "over 30 steps"),
    "quantize_model": ("torch_quantize_model.py", ["--device", "cpu"],
                       "spoga == deas == direct"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_example(name, argv, monkeypatch, capsys) -> str:
    monkeypatch.setattr(sys, "argv", [str(EXAMPLES / name), *argv])
    runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    return capsys.readouterr().out


def test_photonic_sim_prints_the_reference_lines(monkeypatch, capsys):
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import fig5_fps, table1_scalability

    want = "\n".join(table1_scalability.run()) + "\n" + "\n".join(fig5_fps.run()) + "\n"
    got = _run_example("torch_photonic_sim.py", [], monkeypatch, capsys)
    assert got == want
    assert "Table I reproduction: 15/15 cells exact" in got


@pytest.mark.parametrize("case", list(CPU_RUNS))
def test_example_runs_on_cpu(case, monkeypatch, capsys):
    name, argv, marker = CPU_RUNS[case]
    out = _run_example(name, argv, monkeypatch, capsys)
    assert marker in out, out[-2000:]
