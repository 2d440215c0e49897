"""`chip_smoke.py:straggler_count_ok`, the count test that holds kernel
B's straggler flips k against the float64 witness's d on the card
(k <= 2 d + 3 sqrt(k + 4 d)): the H100 readings of correct kernels that
the earlier floor (n - 2 d) / n failed or nearly failed pass, and a
kernel that flips three times as many points as the witness fails once
the counts are large enough to tell (d >= 64).

`chip_smoke.py:agreement_floor`, the floor of E's and F's per-ray
agreement (flags and iteration counts) over n rays as a count, k <=
0.01 n + 3 sqrt(0.01 n): the H100 readings that a bare 0.99 failed at
n < 100 pass, a kernel off on 3% of the rays fails from n = 1,024 on,
and at large n the floor comes back to 0.99.

`chip_holds.py`, which repeats the holds over fresh blocks on the card,
exits with code 2 without one, having loaded nothing of JAX."""
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import agreement_floor, straggler_count_ok  # noqa: E402


# (k, d) read on the H100: k = 14 at d = 6 of n = 115 (floor 0.896,
# read 0.878), 4 at 7 of 129, 10 at 11 of 250
@pytest.mark.parametrize('k,d', [(14, 6), (4, 7), (10, 11), (0, 0),
                                 (2, 0)])
def test_correct_readings_pass(k, d):
    assert straggler_count_ok(k, d)


@pytest.mark.parametrize('d', [64, 100, 1000])
def test_three_times_the_witness_fails(d):
    assert not straggler_count_ok(3 * d, d)
    assert straggler_count_ok(2 * d, d)


def test_bound_grows_with_k():
    """Three Poisson deviations: at d = 0 a handful of flips pass, a
    dozen do not."""
    assert straggler_count_ok(9, 0)
    assert not straggler_count_ok(12, 0)


# (n, k) read on the H100 on the H36M CLI step's block: E's phase-2
# iteration counts off on 2 of 84 and 1 of 82 stragglers (a bare 0.99
# failed both), F's phase-1 counts off on 8 of 1,024
@pytest.mark.parametrize('n,k', [(84, 2), (82, 1), (1024, 8), (45, 0),
                                 (1, 0)])
def test_agreement_readings_pass(n, k):
    assert (n - k) / n >= agreement_floor(n)


@pytest.mark.parametrize('n', [1024, 4096, 32768, 2097152])
def test_three_percent_off_fails(n):
    assert 0.97 < agreement_floor(n) < 0.99


def test_floor_rises_to_099():
    floors = [agreement_floor(n) for n in (10, 100, 1000, 10 ** 5, 10 ** 8)]
    assert floors == sorted(floors)
    assert 0.9899 < floors[-1] < 0.99
    assert agreement_floor(0) == 0.0


def test_chip_holds_needs_a_card():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ('import runpy, sys\n'
            "sys.argv = ['chip_holds.py']\n"
            'try:\n'
            "    runpy.run_path('chip_holds.py', run_name='__main__')\n"
            'except SystemExit as e:\n'
            "    bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'arah_tpu')]\n"
            "    print(e.code, ','.join(bad))\n")
    r = subprocess.run([sys.executable, '-c', code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.stdout.split() == ['2'], (r.stdout, r.stderr)
    assert 'no CUDA device' in r.stderr
