"""Seconds the TCSC_CF phases took in set-up: their tiles, taken from the
main tiles, their plans and their upload (the job executor's
``timings["cf_tiles"]``, ``["cf_plans"]`` and ``["cf_upload"]``, which
``apps/pagerank_cf.py`` puts in the set-up record once the warm-up has
built the phases). None where no phase was built."""

KEYS = ("cf_tiles", "cf_plans", "cf_upload")


def read(ctx):
    s = ctx["setup"]
    if not all(k in s for k in KEYS):
        return None
    return sum(s[k] for k in KEYS)
