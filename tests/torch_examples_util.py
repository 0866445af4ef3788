"""Helpers of the example parity tests (tests/test_torch_examples_*.py):
run a JAX example in this process and keep what it printed, load a port
example from examples/torch, and hold a port number against a printed
one. Not collected by pytest (no test_ prefix).
"""
import importlib.util
import re
import runpy
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
JAX_EXAMPLES = REPO / "examples"
PORT_EXAMPLES = JAX_EXAMPLES / "torch"

NUMBER = r"[-+]?\d+(?:\.\d+)?"


def run_jax_example(name: str, args, monkeypatch, capsys) -> str:
    """Run examples/<name> as ``__main__`` with ``args``; its stdout."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [name, *args])
    runpy.run_path(str(JAX_EXAMPLES / name), run_name="__main__")
    return capsys.readouterr().out


def port_example(name: str):
    """The module examples/torch/<name>.py (its directory on sys.path, so
    its ``from _common import ...`` resolves)."""
    if str(PORT_EXAMPLES) not in sys.path:
        sys.path.insert(0, str(PORT_EXAMPLES))
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  PORT_EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def grab(pattern: str, text: str):
    """The groups of ``pattern``'s first match in ``text`` (it must match)."""
    m = re.search(pattern, text)
    assert m, f"no line matches {pattern!r} in:\n{text}"
    return m.groups()


def assert_printed_close(printed: str, value: float, bar: float, what: str = "") -> None:
    """``printed`` is a number a JAX example printed rounded to its last
    digit: the port's ``value`` agrees with the unrounded one within
    ``bar`` exactly when it lies within ``bar`` plus half a unit of that
    digit of the printed text."""
    decimals = len(printed.split(".")[1]) if "." in printed else 0
    slack = bar + 0.5 * 10.0 ** -decimals
    assert abs(float(printed) - value) <= slack, (what, printed, value, slack)
