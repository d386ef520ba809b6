"""The port's one guarded kernel launch (``vettore_tpu_torch/_build.launch``)
on the CPU, with a fake kernel library and a recorder in place of
``torch.cuda.device`` and ``torch.cuda.current_stream``: it makes the
launch's device current, passes that device's stream, restores the caller's
device, refuses a tensor on another device and raises with the kernel's
name on a CUDA error. An AST check holds every module of the port to it: no
``vt_*`` entry point is called anywhere else.
"""

import ast
from pathlib import Path

import pytest
import torch

from vettore_tpu_torch import _build

PACKAGE = Path(_build.__file__).resolve().parent


class Recorder:
    """The current device of a fake CUDA runtime: ``torch.cuda.device``
    makes its device current and restores the one it found on exit;
    ``current_stream(device)`` is a stream object of that device."""

    def __init__(self, current=0):
        self.current = current
        self.entered = []

    def device(self, dev):
        rec = self

        class Guard:
            def __enter__(self):
                self.prev = rec.current
                rec.current = torch.device(dev).index
                rec.entered.append(torch.device(dev))

            def __exit__(self, *exc):
                rec.current = self.prev

        return Guard()

    def current_stream(self, dev):
        class Stream:
            cuda_stream = 1000 + (torch.device(dev).index or 0)

        return Stream()


class FakeLib:
    """A kernel library whose ``vt_demo`` records its arguments and the
    device current when it ran, and returns ``code``."""

    def __init__(self, rec, code=0):
        self.rec, self.code, self.calls = rec, code, []

    def vt_demo(self, *args):
        self.calls.append((args, self.rec.current))
        return self.code

    def vt_error_string(self, code):
        return f"fake error {code}".encode()


@pytest.fixture
def fake(monkeypatch):
    rec = Recorder(current=0)
    lib = FakeLib(rec)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", rec.device)
    monkeypatch.setattr(torch.cuda, "current_stream", rec.current_stream)
    monkeypatch.setattr(_build, "CARD_LAUNCHES", type(_build.CARD_LAUNCHES)())
    return rec, lib


@pytest.mark.parametrize("index", [0, 1, 3])
def test_launch_runs_on_its_device_and_restores_the_callers(fake, index):
    rec, lib = fake
    dev = torch.device("cuda", index)
    _build.launch("demo", dev, 7, None, 2)
    # the arguments in order, then the launch device's stream, with that
    # device current during the call
    assert lib.calls == [((7, None, 2, 1000 + index), index)]
    assert rec.entered == [dev]
    assert rec.current == 0
    assert _build.CARD_LAUNCHES == {("demo", index): 1}


def test_launch_passes_tensors_as_their_data_pointers(fake):
    _rec, lib = fake
    t = torch.arange(4, dtype=torch.float32)
    _build.launch("demo", t.device, t, 3)
    assert lib.calls[0][0][:2] == (t.data_ptr(), 3)


def test_launch_refuses_a_tensor_on_another_device(fake):
    _rec, lib = fake
    with pytest.raises(ValueError, match="demo: operands on cpu and cuda:1"):
        _build.launch("demo", torch.device("cuda", 1), torch.zeros(2), 3)
    assert lib.calls == [] and not _build.CARD_LAUNCHES


def test_launch_raises_with_the_kernels_name(fake):
    rec, lib = fake
    lib.code = 700
    with pytest.raises(RuntimeError, match=r"demo launch failed: CUDA error 700 \(fake error 700\)"):
        _build.launch("demo", torch.device("cuda", 2), 1)
    assert rec.current == 0  # restored on the error path too
    assert not _build.CARD_LAUNCHES


def _vt_uses(tree):
    """``(function, what)`` of every call of a ``vt_*`` attribute and every
    ``getattr`` of a ``vt_*`` name (a string or an f-string) in ``tree``."""
    found = []

    def visit(node, fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = node.name
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr.startswith("vt_"):
                found.append((fn, f.attr))
            if isinstance(f, ast.Name) and f.id == "getattr" and len(node.args) >= 2:
                name = node.args[1]
                if isinstance(name, ast.JoinedStr):
                    name = name.values[0]
                if isinstance(name, ast.Constant) and str(name.value).startswith("vt_"):
                    found.append((fn, f"getattr {name.value}"))
        for child in ast.iter_child_nodes(node):
            visit(child, fn)

    visit(tree, None)
    return found


def test_no_module_calls_a_kernel_entry_but_through_launch():
    uses = {}
    for path in sorted(PACKAGE.rglob("*.py")):
        found = _vt_uses(ast.parse(path.read_text(), filename=str(path)))
        if found:
            uses[str(path.relative_to(PACKAGE))] = sorted(found)
    # the kernels' entry points only in launch; check reads the error string
    assert uses == {"_build.py": [("check", "vt_error_string"), ("launch", "getattr vt_")]}


def test_every_kernel_wrapper_launches_through_the_helper():
    """The seven launch sites (K1, K2 and K4 through ``_group_rescore``, K3,
    K5, K6, K7 and MaxSim) each call ``_build.launch``."""
    callers = []
    for rel in ("ops/flat_scan.py", "ops/maxsim.py"):
        tree = ast.parse((PACKAGE / rel).read_text())
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                for node in ast.walk(fn):
                    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                            and node.func.attr == "launch"
                            and getattr(node.func.value, "id", None) == "_build"):
                        callers.append(fn.name)
    assert sorted(callers) == sorted([
        "gmin_scan", "_group_rescore", "int8_gmin_scan", "stage_gmin_scan",
        "fused_sign_scan", "extract_group_rows", "maxsim_rank_scan"])


@pytest.mark.parametrize("call", ["gmin_scan", "rescore", "stage_gmin_scan", "int8_gmin_scan",
                                  "int8_rescore", "fused_sign_scan", "extract_group_rows",
                                  "maxsim_rank_scan"])
def test_wrappers_refuse_operands_on_another_device(call):
    """A wrapper given operands on two devices raises ``ValueError`` before
    anything runs (``meta`` tensors stand in for a second device)."""
    from vettore_tpu_torch.ops import flat_scan as fs
    from vettore_tpu_torch.ops import maxsim as ms

    n, d, b = 128, 16, 2
    x = torch.zeros((n, d))
    xsq, bias, q = torch.zeros(n), torch.zeros(n), torch.zeros((b, d))
    gidx = torch.zeros((b, 1), dtype=torch.int32)
    meta = {"device": "meta"}
    with pytest.raises(ValueError, match="operands on"):
        if call == "gmin_scan":
            fs.gmin_scan(x, xsq, bias, q.to(**meta), metric="cosine")
        elif call == "rescore":
            fs.rescore(x, xsq, bias, q, gidx.to(**meta), metric="cosine")
        elif call == "stage_gmin_scan":
            fs.stage_gmin_scan(x, xsq.to(**meta), bias, q, metric="cosine", dims=8)
        elif call == "int8_gmin_scan":
            x8, q8 = x.to(torch.int8), q.to(torch.int8)
            fs.int8_gmin_scan(x8, xsq, xsq, bias, q8, torch.zeros(b, **meta), torch.zeros(b),
                              metric="cosine")
        elif call == "int8_rescore":
            fs.int8_rescore(x.to(torch.int8), xsq, xsq, bias, q, gidx.to(**meta),
                            metric="cosine")
        elif call == "fused_sign_scan":
            s8 = x.to(torch.int8)
            fs.fused_sign_scan(s8, torch.ones(n, dtype=torch.int8, **meta), q.to(torch.int8),
                               d=d)
        elif call == "extract_group_rows":
            fs.extract_group_rows(torch.zeros((b, 2, 64)), gidx.to(**meta))
        else:
            tokens = torch.zeros((n, 2, d))
            ms.maxsim_rank_scan(tokens, torch.full((n,), 2, dtype=torch.int32), torch.zeros(n),
                                torch.zeros((b, d), **meta), torch.ones(b), b=b,
                                metric="inner_product")
