"""Line-by-line comparison of two runs' printed output: an example's twin
on the PyTorch port against the reference script, or a twin on the card
against the same twin on the host.

`compare_printed(want, got, ...)` returns the disagreements it found (an
empty list when the outputs agree):

* the text between the numbers must be equal, once each ``(want_phrase,
  got_phrase)`` of ``phrases`` is substituted into ``want`` (the phrases
  that name an engine: "one lax.scan" against what the port does) and
  what each regex of ``dropped`` finds is taken out of ``want`` (what the
  reference prints of a mechanism the port does not have, such as XLA's
  compile seconds); a run of spaces counts as one, since a column padded
  to its number's printed width moves with the number;
* a number with neither a decimal point nor an exponent is an integer and
  must be equal: bytes, transfers, counts, list entries;
* every substring a regex of ``exact`` finds must be equal on both sides
  (a float printed from an exact integer, such as megabytes of bytes);
* any other number must agree within the golden tolerance (``RTOL``,
  ``ATOL``), widened by one unit in its last printed
  digit, since two values that agree may still round to neighbouring
  digits; with ``floats=False`` (two runs that parted at a top-k near-tie
  before they printed) such numbers are not compared;
* what the first group of a regex of ``machine`` captures is left out on
  both sides: host wall-clock seconds, and counts of the builds a process
  made so far (the fields the reference's parity view drops as
  machine-dependent).

The module imports neither torch nor anything of the repository, so a
test and ``chip_smoke.py`` can both load it by path.
"""

from __future__ import annotations

import re

RTOL, ATOL = 1e-4, 1e-6
NUMBER = re.compile(r"([-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?)")


def _unit(token: str) -> float:
    """One unit in the last printed digit of a float token."""
    mant, _, exp = token.lower().partition("e")
    decimals = len(mant.split(".", 1)[1]) if "." in mant else 0
    return 10.0 ** ((int(exp) if exp else 0) - decimals)


def _is_int(token: str) -> bool:
    return "." not in token and "e" not in token.lower()


def _spaced(text: str) -> str:
    return re.sub(r" +", " ", text)


def _masked(text: str, machine) -> str:
    for pattern in machine:
        text = re.sub(pattern, lambda mt: mt.group(0).replace(mt.group(1), "<machine>", 1), text)
    return text


def compare_printed(want: str, got: str, *, phrases=(), dropped=(), machine=(), exact=(),
                    floats: bool = True) -> list[str]:
    for ref_phrase, twin_phrase in phrases:
        if ref_phrase not in want:
            return [f"the phrase {ref_phrase!r} is not in the expected output"]
        want = want.replace(ref_phrase, twin_phrase)
    for pattern in dropped:
        want, n = re.subn(pattern, "", want)
        if not n:
            return [f"{pattern!r} finds nothing to drop in the expected output"]
    want_lines = _masked(want, machine).splitlines()
    got_lines = _masked(got, machine).splitlines()
    if len(want_lines) != len(got_lines):
        return [f"{len(got_lines)} lines, want {len(want_lines)}"]
    problems = []
    for n, (w, g) in enumerate(zip(want_lines, got_lines)):
        for pattern in exact:
            if re.findall(pattern, w) != re.findall(pattern, g):
                problems.append(f"line {n}: {pattern!r} found {re.findall(pattern, g)}, want "
                                f"{re.findall(pattern, w)}\n  got  {g}\n  want {w}")
        wp, gp = NUMBER.split(w), NUMBER.split(g)
        if len(wp) != len(gp) or [_spaced(t) for t in wp[0::2]] != [_spaced(t) for t in gp[0::2]]:
            problems.append(f"line {n}: the text differs\n  got  {g}\n  want {w}")
            continue
        for a, b in zip(gp[1::2], wp[1::2]):
            if _is_int(a) and _is_int(b):
                ok = int(a) == int(b)
            elif not floats:
                ok = True
            else:
                ok = abs(float(a) - float(b)) <= ATOL + RTOL * abs(float(b)) + max(_unit(a), _unit(b))
            if not ok:
                problems.append(f"line {n}: {a} against {b}\n  got  {g}\n  want {w}")
    return problems
