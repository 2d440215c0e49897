"""Kernel C's share of its roofline while images render: its least time at
the traced images' padded chunks (`flops.c_least_s`) over its device
time, in percent."""


def read(facts):
    if facts.get('kind') != 'render' or 'trace' not in facts:
        return None
    dev = facts['trace'].family_s.get('C')
    if not dev:
        return None
    return 100.0 * facts['least_s']['C'] / dev
