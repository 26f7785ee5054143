"""The nine ``examples/*_torch.py`` twins against the reference's own
scripts, on the CPU: quickstart, coefficient tuning and wan_bilevel here
(the helpers too, the twins' refusal of a missing card and
`selection.compared`); hyper-representation in
``test_torch_examples_hyper.py``; the async and telemetry twins in
``test_torch_examples_async.py``; the transport, serve and LM twins in
``test_torch_examples_launch.py``.

Each test loads the reference script and its twin by path and runs both in
this process at a reduced size, changing module globals only (no edit to
``examples/*.py``): the task factory keeps m, c, h and the seed and takes a
smaller n and p, the twin's factory returns the port's bundle built from the
reference's own arrays (`repro_torch.core.convert.from_numpy`), and ``run``
(or the per-algorithm runner) is wrapped to cap a hard-coded T at a few
rounds.  The captured outputs are compared line by line
(``examples/_compare_torch.py``): text equal but for the phrases that name
the engine, listed in each test; integers equal; megabytes of exact bytes
equal; floats within the golden rtol 1e-4 / atol 1e-6 widened by one unit
in the last printed digit; host wall seconds left out.

About 25 s on one worker (quickstart first: wan_bilevel's reference reuses
its jitted run)."""

import contextlib
import dataclasses
import importlib.util
import inspect
import io
import sys
from pathlib import Path

import jax  # noqa: F401  (the reference's scripts import it; loaded first, as in every parity test)
import numpy as np
import pytest
import torch

from repro.data import bilevel_tasks as jtasks
from repro_torch.core.convert import from_numpy
from repro_torch.data import bilevel_tasks as ptasks

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
MB = r"[\d.]+ ?MB"  # megabytes printed from exact integer bytes


def load(name: str):
    """An ``examples/`` script as a fresh module (its ``__main__`` block
    does not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


COMPARE = load("_compare_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while these files run (several test workers
    share the machine's cores; see tests/test_torch_launchers.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def capped(fn, T: int):
    """``fn`` with its argument ``T`` (keyword or positional) capped."""
    sig = inspect.signature(fn)

    def wrapped(*args, **kw):
        bound = sig.bind(*args, **kw)
        bound.arguments["T"] = min(bound.arguments["T"], T)
        return fn(*bound.args, **bound.kwargs)

    return wrapped


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: np.asarray(v) for k, v in tree.items()}
    return np.asarray(tree)


def task_factories(name: str, small: dict):
    """The reference's factory ``name`` at the reduced size, and the
    twin's: the port's bundle of the same arguments (its data equal the
    reference's bit for bit) carrying the reference's x0 and y0."""
    jfactory, pfactory = getattr(jtasks, name), getattr(ptasks, name)

    def ref(**kw):
        return jfactory(**{**kw, **small})

    def twin(device=None, **kw):
        kw = {**kw, **small}
        jb, pb = jfactory(**kw), pfactory(**kw, device=device)
        return dataclasses.replace(pb, x0=from_numpy(_numpy_tree(jb.x0), device),
                                   y0=from_numpy(_numpy_tree(jb.y0), device))

    return ref, twin


def printed(main, argv=None) -> str:
    """What ``main`` prints (``argv`` None: a reference main that takes no
    arguments, or reads the empty ``sys.argv`` tail)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main() if argv is None else main(argv)
    return buf.getvalue()


def record_reference_selections(monkeypatch) -> list:
    """Every top-k compression the reference makes from here on, in order,
    as ``(rows, kept)`` torch tensors (one row a node, the residual and the
    coordinates it kept), read out of its jitted bodies by debug callbacks
    around ``compress_stacked``: the log `repro_torch.core.selection.imposed`
    takes.  Call ``jax.effects_barrier()`` before reading it."""
    from repro.core import baselines as jbase
    from repro.core import compression as jcomp
    from repro.core import inner_loop as jinner

    log = []
    stacked = jinner.compress_stacked

    def append(n, *arrays):
        for x, q in zip(arrays[:n], arrays[n:]):
            rows = np.asarray(x).reshape(x.shape[0], -1)
            log.append((torch.from_numpy(rows.copy()), torch.from_numpy(np.asarray(q).reshape(rows.shape) != 0)))

    def recording(compressor, key, tree):
        out = stacked(compressor, key, tree)
        if isinstance(compressor, jcomp.TopK):
            xs, qs = jax.tree.leaves(tree), jax.tree.leaves(out)
            jax.debug.callback(lambda *a: append(len(xs), *a), *xs, *qs, ordered=True)
        return out

    monkeypatch.setattr(jinner, "compress_stacked", recording)
    monkeypatch.setattr(jbase, "compress_stacked", recording)
    return log


def assert_same_printed(want: str, got: str, **kw) -> None:
    problems = COMPARE.compare_printed(want, got, **kw)
    assert not problems, "\n".join(problems) + f"\n--- reference\n{want}\n--- twin\n{got}"


def run_pair(monkeypatch, name: str, patches, ref_argv: list, twin_argv: list) -> tuple[str, str]:
    """Both scripts' printed output: ``patches(ref, twin)`` sets their
    globals; the reference reads ``sys.argv``, the twin takes argv."""
    ref, twin = load(name), load(f"{name}_torch")
    patches(ref, twin)
    monkeypatch.setattr(sys, "argv", [name] + ref_argv)
    want = printed(ref.main)
    got = printed(twin.main, twin_argv + ["--device", "cpu"])
    return want, got


COEF_SMALL = dict(n=400, p=30)


def coefficient_patches(monkeypatch, T: int):
    """The reduced coefficient-tuning task on both sides, ``run`` capped at T."""

    def patches(ref, twin):
        ref.coefficient_tuning_task, twin.coefficient_tuning_task = task_factories("coefficient_tuning_task",
                                                                                   COEF_SMALL)
        monkeypatch.setattr(ref, "run", capped(ref.run, T))
        monkeypatch.setattr(twin, "run", capped(twin.run, T))

    return patches


def test_quickstart(monkeypatch):
    want, got = run_pair(monkeypatch, "quickstart", coefficient_patches(monkeypatch, 3), [], [])
    assert_same_printed(want, got)


def test_coefficient_tuning(monkeypatch):
    """--fast: h = 0.8, three topologies, C2DFB, MADSBO and MDBO, each
    runner capped at 5 rounds (one accuracy sample, at round 5)."""

    def patches(ref, twin):
        ref.coefficient_tuning_task, twin.coefficient_tuning_task = task_factories("coefficient_tuning_task",
                                                                                   COEF_SMALL)
        for mod in (ref, twin):
            for runner in ("run_c2dfb", "run_mdbo", "run_madsbo"):
                monkeypatch.setattr(mod, runner, capped(getattr(mod, runner), 5))

    want, got = run_pair(monkeypatch, "coefficient_tuning", patches, ["--fast"], ["--fast"])
    assert_same_printed(want, got, exact=[MB, r"acc@[\d.]+MB"])


def test_wan_bilevel(monkeypatch, tmp_path):
    """The WAN-priced run (codec bytes a round, the megabytes of exact
    bytes, transfers in the exported trace: all equal) and the flaky-link
    run under a dropout schedule."""
    out = str(tmp_path)
    want, got = run_pair(monkeypatch, "wan_bilevel", coefficient_patches(monkeypatch, 3), ["--out", out],
                         ["--out", out])
    assert_same_printed(want, got, exact=[MB])


@pytest.mark.parametrize("name", ["quickstart", "coefficient_tuning", "hyper_representation", "wan_bilevel",
                                  "async_bilevel", "observability", "transport_backends", "serve_batch",
                                  "decentralized_llm_bilevel"])
def test_a_twin_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch, name):
    """``--device`` defaults to cuda; with no card the twin raises before
    any work (no silent fallback to the host)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    twin = load(f"{name}_torch")
    monkeypatch.setattr(sys, "argv", [name])
    with pytest.raises(RuntimeError, match='no CUDA device is available; pass device="cpu"'):
        twin.main([])


def test_compared_finds_the_first_parting_and_holds_it_to_a_near_tie():
    """`selection.compared` (phase 16's card-against-host check of
    wan_bilevel and transport_backends): a run whose selections never part
    passes with ``first`` None; one whose residual moves the k-th and
    (k+1)-th magnitudes past each other by rounding parts there, and its
    relative gap is the near-tie's; later compressions are only counted; a
    residual beyond the golden tolerance before the parting, and runs that
    compress other leaves, or more or less often, raise."""
    from repro_torch.core import selection
    from repro_torch.core.compression import TopK

    comp = TopK(ratio=0.25)  # k = 2 of 8
    rows = [torch.tensor([[4.0, 3.0, 3.0 - 1e-6, 1.0, 0.5, 0.4, 0.3, 0.2]]), torch.tensor([[1.0, 2.0, 3.0, 4.0] * 2])]
    log = []
    with selection.recorded(log):
        for x in rows:
            comp.compress_nodes(x)

    seen = selection.Partings()
    with selection.compared(log, seen):
        for x in rows:
            comp.compress_nodes(x)
    assert (seen.compressions, seen.first, seen.rows) == (2, None, 0)

    tie = rows[0].clone()
    tie[0, 1], tie[0, 2] = 3.0 - 1e-6, 3.0  # the 2nd and 3rd magnitudes, 1e-6 apart, swapped
    seen = selection.Partings()
    with selection.compared(log, seen):
        comp.compress_nodes(tie)
        comp.compress_nodes(rows[1] + 5.0)  # after the parting nothing is compared
    assert (seen.compressions, seen.first, seen.rows) == (2, 0, 1)
    assert seen.rel_gap < 1e-6 and seen.of_allowance <= 1.0

    with pytest.raises(AssertionError, match="beyond the golden tolerance"):
        with selection.compared(log, selection.Partings()):
            comp.compress_nodes(rows[0] * 1.01)  # the same choice on a residual 1% away
            comp.compress_nodes(rows[1])
    with pytest.raises(AssertionError, match="compress different leaves"):
        with selection.compared(log, selection.Partings()):
            comp.compress_nodes(rows[0][:, :4])
    with pytest.raises(AssertionError, match="never made"):
        with selection.compared(log, selection.Partings()):
            comp.compress_nodes(rows[0])
    with pytest.raises(AssertionError, match="more often"):
        with selection.compared(log, selection.Partings()):
            for x in rows + rows:
                comp.compress_nodes(x)
