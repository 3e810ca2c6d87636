"""The port's NillableDuration (karpenter_tpu_torch/api/duration.py) parses
and formats as the JAX package's over a table of inputs: units, compound
strings, signs, "Never", numbers, and malformed strings (the same error
type and message)."""

import math

import pytest

from karpenter_tpu.api import duration as jdur
from karpenter_tpu_torch.api import duration as pdur

PARSED = [None, 0, 7, 2.5, -3.0, "0", "+0", "-0", "Never", " Never ",
          "10m", "1h30m", "90s", "1.5h", ".5s", "300ms", "250us", "250µs",
          "40ns", "2h45m30s", "-1m30s", "+15m", "720h", "1h0m0s", " 5m ",
          "0.000001s", "100h", "1m1m",
          # the reference's quirks, kept: an empty string is 0, and every
          # leading sign is stripped before the units are matched
          "", "--1s"]
MALFORMED = ["10", "never", "1d", "5 m", "m5", "1h-30m", "abc", "1.h",
             "1s x", "h"]
FORMATTED = [None, 0, 0.0, 1, 59.5, 60, 61, 3600, 3661, 86400, 90061.25,
             720 * 3600.0, 0.25, 0.001, 1e-9, 123456.789]


@pytest.mark.parametrize("value", PARSED, ids=repr)
def test_parse_duration_matches(value):
    got, want = pdur.parse_duration(value), jdur.parse_duration(value)
    assert (got is None) == (want is None)
    if want is not None:
        assert got == want and not math.isnan(got)


@pytest.mark.parametrize("value", MALFORMED, ids=repr)
def test_malformed_durations_raise_the_same_error(value):
    with pytest.raises(ValueError) as want:
        jdur.parse_duration(value)
    with pytest.raises(ValueError) as got:
        pdur.parse_duration(value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("value", FORMATTED, ids=repr)
def test_format_duration_matches(value):
    assert pdur.format_duration(value) == jdur.format_duration(value)


def test_never_constant():
    assert pdur.NEVER == jdur.NEVER == "Never"
    assert pdur.parse_duration(pdur.format_duration(None)) is None
    for s in (60.0, 3661.0, 720 * 3600.0):
        assert pdur.parse_duration(pdur.format_duration(s)) == s
