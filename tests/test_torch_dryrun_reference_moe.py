"""The port's dry run held to the JAX reference's compiled dry run on the
mixture-of-experts cases: mixtral-8x7b (train_4k at baseline, under
``moe_local`` and ``moe_local_dots``; prefill_32k, decode_32k and
long_500k) and the hybrid jamba-1.5-large-398b (decode_32k, long_500k).
The method is `_torch_dryrun_ref`'s (the fake 16 x 16 mesh, one repeat of
the pattern, every width the config's).  Per case:

* argument bytes per device equal;
* per-device FLOPs within 0.95-1.05 of the reference's;
* temp bytes per device at most max(1.5 x the reference's, the
  reference's + 64 MiB): a decode step's XLA temp is tens of MB, where a
  fused buffer assignment and an eager live-storage count part by small
  intermediates (64 MiB is 0.08% of an H100's 80 GB);
* collective bytes per device at most 2 x the reference's;
* on train_4k and prefill_32k at baseline, collective bytes at least 0.5 x
  the reference's: the reference's baseline dispatch has one global
  capacity, its (E, C, D) buffer a sum over the data shards, and that
  reduction is what the ``moe_local`` variant exists to remove; a port
  that dispatched each shard's tokens on their own would move 6% of it.

The reference's subprocess compiles while the port's side runs; about 40
s on one worker."""

import pytest
from _torch_dryrun_ref import both

CASES = [
    "mixtral-8x7b/train_4k",
    "mixtral-8x7b/train_4k/moe_local",
    "mixtral-8x7b/train_4k/moe_local_dots",
    "mixtral-8x7b/prefill_32k",
    "mixtral-8x7b/decode_32k",
    "mixtral-8x7b/long_500k",
    "jamba-1.5-large-398b/decode_32k",
    "jamba-1.5-large-398b/long_500k",
]
GLOBAL_DISPATCH = ["mixtral-8x7b/train_4k", "mixtral-8x7b/prefill_32k"]
FLOPS_BOUND = (0.95, 1.05)
TEMP_BOUND, TEMP_SLACK = 1.5, 64 * 2**20
COLLECTIVE_BOUND = (0.5, 2.0)


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
    ref = reference[case]["temp"]
    assert port[case]["temp"] <= max(TEMP_BOUND * ref, ref + TEMP_SLACK), (port[case]["temp"], ref)


@pytest.mark.parametrize("case", CASES)
def test_collective_bytes_within_the_bound(records, case):
    reference, port = records
    ratio = port[case]["collectives"] / reference[case]["collectives"]
    assert ratio <= COLLECTIVE_BOUND[1], (port[case]["collectives"], reference[case]["collectives"], ratio)


@pytest.mark.parametrize("case", GLOBAL_DISPATCH)
def test_global_dispatch_moves_the_reference_share_of_collectives(records, case):
    reference, port = records
    ratio = port[case]["collectives"] / reference[case]["collectives"]
    assert ratio >= COLLECTIVE_BOUND[0], (port[case]["collectives"], reference[case]["collectives"], ratio)
