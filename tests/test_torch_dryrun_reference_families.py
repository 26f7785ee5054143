"""The port's dry run held to the JAX reference's compiled dry run on the
other families and variants: Mamba-2 (mamba2-2.7b: train_4k, prefill_32k,
decode_32k, long_500k), audio (seamless-m4t-medium: train_4k,
prefill_32k, decode_32k), VLM (llama-3.2-vision-11b: train_4k,
prefill_32k, decode_32k), the ``remat_dots`` variant (phi3-mini-3.8b and
gemma2-27b train_4k), the ``decode_stationary`` variant (phi3-mini-3.8b
and gemma2-27b decode_32k) and gemma2-27b long_500k.  The method is
`_torch_dryrun_ref`'s (the fake 16 x 16 mesh, one repeat of the pattern,
every width the config's).  Per case:

* argument bytes per device equal (the reference's jit prunes an argument
  its step never reads: mamba2's decode position, seamless's encoder at
  decode; the port counts only what its step reads);
* per-device FLOPs within 0.95-1.05 of the reference's;
* temp bytes per device at most max(1.5 x the reference's, the
  reference's + 64 MiB): mamba2-2.7b long_500k's XLA temp is 0.2 MB, where
  a fused buffer assignment and an eager live-storage count part by small
  intermediates (64 MiB is 0.08% of an H100's 80 GB);
* collective bytes per device at most 2 x the reference's.

The reference's subprocess compiles while the port's side runs; about 70
s on one worker."""

import pytest
from _torch_dryrun_ref import both

CASES = [
    "mamba2-2.7b/train_4k",
    "mamba2-2.7b/prefill_32k",
    "mamba2-2.7b/decode_32k",
    "mamba2-2.7b/long_500k",
    "seamless-m4t-medium/train_4k",
    "seamless-m4t-medium/prefill_32k",
    "seamless-m4t-medium/decode_32k",
    "llama-3.2-vision-11b/train_4k",
    "llama-3.2-vision-11b/prefill_32k",
    "llama-3.2-vision-11b/decode_32k",
    "phi3-mini-3.8b/train_4k/remat_dots",
    "gemma2-27b/train_4k/remat_dots",
    "phi3-mini-3.8b/decode_32k/decode_stationary",
    "gemma2-27b/decode_32k/decode_stationary",
    "gemma2-27b/long_500k",
]
FLOPS_BOUND = (0.95, 1.05)
TEMP_BOUND, TEMP_SLACK = 1.5, 64 * 2**20
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
    ref = reference[case]["temp"]
    assert port[case]["temp"] <= max(TEMP_BOUND * ref, ref + TEMP_SLACK), (port[case]["temp"], ref)


@pytest.mark.parametrize("case", CASES)
def test_collective_bytes_within_the_bound(records, case):
    reference, port = records
    ratio = port[case]["collectives"] / reference[case]["collectives"]
    assert ratio <= COLLECTIVE_BOUND, (port[case]["collectives"], reference[case]["collectives"], ratio)
