"""The port's dry run (`repro_torch.launch.dryrun`) held to the JAX
reference's own compiled dry run at production size, on eight dense,
baseline cases (the method: `_torch_dryrun_ref`; every width the
config's, one repeat of its pattern).  Per case:

* argument bytes per device equal;
* per-device FLOPs within 0.95-1.05 of the reference's;
* temp bytes per device at most 1.5 x the reference's: XLA's CPU buffer
  assignment is not an allocator, and nothing bounds temp from below here
  (the card's own allocator does, `chip_smoke.py` phase 15 (b));
* collective bytes per device at most 2 x the reference's: DTensor's
  collectives are not GSPMD's by kind (an all-reduce where XLA may issue
  a reduce-scatter and an all-gather).

The eight cases cover each layout the bounds guard: the vocabulary-
parallel cross-entropy and embedding (every train case), heads that the
model axis does not divide (qwen2-7b's 28 on 16), masks at each device's
batch (the prefills) and the decode cache written on its shards.  About
40 s on one worker, the reference's compiles overlapping the port's side."""

import pytest
from _torch_dryrun_ref import both

CASES = [
    "phi3-mini-3.8b/train_4k",
    "qwen2-7b/train_4k",
    "gemma2-27b/train_4k",
    "nemotron-4-15b/train_4k",
    "phi3-mini-3.8b/prefill_32k",
    "qwen2-7b/prefill_32k",
    "phi3-mini-3.8b/decode_32k",
    "gemma2-27b/decode_32k",
]
FLOPS_BOUND = (0.95, 1.05)
TEMP_BOUND = 1.5
COLLECTIVE_BOUND = 2.0


@pytest.fixture(scope="module")
def records():
    return both(CASES)


@pytest.mark.parametrize("case", CASES)
def test_argument_bytes_equal_the_reference(records, case):
    reference, port = records
    assert port[case]["argument"] == reference[case]["argument"]


@pytest.mark.parametrize("case", CASES)
def test_flops_per_device_near_the_reference(records, case):
    reference, port = records
    ratio = port[case]["flops"] / reference[case]["flops"]
    assert FLOPS_BOUND[0] <= ratio <= FLOPS_BOUND[1], (port[case]["flops"], reference[case]["flops"], ratio)


@pytest.mark.parametrize("case", CASES)
def test_temp_bytes_within_the_bound(records, case):
    reference, port = records
    ratio = port[case]["temp"] / reference[case]["temp"]
    assert ratio <= TEMP_BOUND, (port[case]["temp"], reference[case]["temp"], ratio)


@pytest.mark.parametrize("case", CASES)
def test_collective_bytes_within_the_bound(records, case):
    reference, port = records
    ratio = port[case]["collectives"] / reference[case]["collectives"]
    assert ratio <= COLLECTIVE_BOUND, (port[case]["collectives"], reference[case]["collectives"], ratio)
