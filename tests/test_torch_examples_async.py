"""The async and telemetry twins (``examples/async_bilevel_torch.py``,
``examples/observability_torch.py``) against the reference's own scripts on
the CPU, by the rules and helpers of ``test_torch_examples.py``, artifacts
under pytest's temporary directory.

* async_bilevel: the coefficient-tuning task at n = 400, p = 30 (m, c, h
  and the seed the script's), ``run`` capped at 3 rounds.
* observability: the script's six-node task at n = 200, p = 30, all eight
  rounds (the heartbeats every 2 rounds and the last round's node rows are
  what the script prints).  The script's own asserts (the engines' parity
  rows equal, C2DFB's hvp and jvp columns zero, every engine pricing a
  round alike) run in both.

About 37 s on one worker."""

from test_torch_examples import assert_same_printed, coefficient_patches, run_pair, task_factories

# host wall seconds in the async script's compiled line (machine-dependent)
ASYNC_MACHINE = [r"rounds in ([\d.]+)s host wall-clock"]
# machine-dependent readings in observability's output: the watch's record
# age, the summary's wall seconds, its host spans and its trace counts (the
# builds this process made so far: the reference counts its earlier runs'
# jitted scans, the port builds no scan)
OBS_MACHINE = [r"last record ([\d.]+)s ago", r"wall_seconds +([\d.e+-]+)", r"timing [\w+]+ +([\d.e+-]+) s",
               r"trace_counts +(.*)"]
# XLA's compile seconds, in the watch's compute line and the summary: the
# port compiles nothing
XLA_COMPILE = [r"   compile=[\d.]+s", r"  compile_seconds +[\d.e+-]+\n"]


def test_async_bilevel(monkeypatch, tmp_path):
    """The four gating policies' simulated seconds, accuracy and staleness,
    the compiled runtime's simulated seconds (its host wall left out) and
    the speed-up; the compiled line names what the port replays."""
    out = str(tmp_path)
    want, got = run_pair(monkeypatch, "async_bilevel", coefficient_patches(monkeypatch, 3), ["--out", out],
                         ["--out", out])
    assert_same_printed(want, got, phrases=[("one lax.scan", "replayed round bodies")], machine=ASYNC_MACHINE)


def test_observability(monkeypatch, tmp_path):
    ref_out, twin_out = str(tmp_path / "ref"), str(tmp_path / "twin")

    def patches(ref, twin):
        ref.coefficient_tuning_task, twin.coefficient_tuning_task = task_factories("coefficient_tuning_task",
                                                                                   dict(n=200, p=30))

    want, got = run_pair(monkeypatch, "observability", patches, ["--out", ref_out], ["--out", twin_out])
    assert_same_printed(want, got, phrases=[(ref_out, twin_out), ("repro.obs", "repro_torch.obs")],
                        dropped=XLA_COMPILE, machine=OBS_MACHINE)
