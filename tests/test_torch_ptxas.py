"""`arah_tpu_torch/utils/ptxas.py`, the parse of the kernel build's ptxas
report that `chip_smoke.py`'s build check reads, on a hand-made log: each
`Function properties` block goes to the function it names (a device
function that was not inlined keeps its own spills, whichever entry ptxas
printed before it), the registers to the entry being compiled, and
`group` holds every function of the checked entries' sources, and two
functions that share a key (they differ only in a type argument) keep the
worse numbers."""
from arah_tpu_torch.utils import ptxas

LOG = """== corr_rows.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z11corr_kernelI9TileShapeILi64ELi256EELi2ELb1EEv8CorrArgs' for 'sm_90a'
ptxas info    : Function properties for _Z11corr_kernelI9TileShapeILi64ELi256EELi2ELb1EEv8CorrArgs
    64 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _Z14corr_jac_flushI9TileShapeILi64ELi256EELi2EEvv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 163 registers, used 1 barriers, 72 bytes cumulative stack size, 19600 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z11corr_kernelI9TileShapeILi64ELi256EELi2ELb0EEv8CorrArgs' for 'sm_90a'
ptxas info    : Function properties for _Z11corr_kernelI9TileShapeILi64ELi256EELi2ELb0EEv8CorrArgs
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 95 registers, used 1 barriers, 32 bytes cumulative stack size, 19600 bytes smem, 400 bytes cmem[0]

== knn.cu
ptxas info    : Compiling entry function '_Z10knn_kernelILi256EEv7KnnArgs' for 'sm_90a'
ptxas info    : Function properties for _Z10knn_kernelILi256EEv7KnnArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 1024 bytes smem
"""


def test_each_block_goes_to_the_function_it_names():
    r = ptxas.parse(LOG)
    jac = r['corr_kernel<64, 256, 2, true>']
    assert jac == {'entry': True, 'source': 'corr_rows.cu', 'stack': 64,
                   'spill_stores': 0, 'spill_loads': 0, 'registers': 163,
                   'smem': 19600}
    flush = r['corr_jac_flush<64, 256, 2> [corr_rows.cu]']
    assert flush == {'entry': False, 'source': 'corr_rows.cu', 'stack': 8,
                     'spill_stores': 4, 'spill_loads': 4}
    assert r['corr_kernel<64, 256, 2, false>']['registers'] == 95
    assert r['knn_kernel<256>']['source'] == 'knn.cu'


def test_group_holds_the_callees_of_the_checked_sources():
    r = ptxas.parse(LOG)
    ks, callees = ptxas.group(r, ['corr_kernel<'])
    assert sorted(ks) == ['corr_kernel<64, 256, 2, false>',
                          'corr_kernel<64, 256, 2, true>']
    assert list(callees) == ['corr_jac_flush<64, 256, 2> [corr_rows.cu]']
    # the entries are clean; the not-inlined callee's spill fails the check
    assert not any(map(ptxas.spills, ks.values()))
    assert any(map(ptxas.spills, callees.values()))
    ks, callees = ptxas.group(r, ['knn_kernel<'])
    assert list(ks) == ['knn_kernel<256>'] and callees == {}
    # a report without the spill line counts as a spill (no weaker check)
    assert ptxas.spills({'entry': True, 'registers': 10})


def test_a_shared_key_keeps_the_worst_block():
    """Two instantiations of one callee that differ only in a type
    argument demangle to one name: the spilling block is kept whichever
    comes first, and so are the larger registers of two such entries."""
    spill = ("ptxas info    : Function properties for "
             "_Z14corr_jac_flushI9TileShapeILi64ELi256EELi2EEvv\n"
             "    8 bytes stack frame, 4 bytes spill stores, "
             "4 bytes spill loads\n")
    clean = ("ptxas info    : Function properties for "
             "_Z14corr_jac_flushI8JacShapeILi64ELi256EELi2EEvv\n"
             "    0 bytes stack frame, 0 bytes spill stores, "
             "0 bytes spill loads\n")
    entry = ("ptxas info    : Compiling entry function "
             "'_Z11corr_kernelI{t}ILi64ELi256EELi2ELb1EEv8CorrArgs' for "
             "'sm_90a'\nptxas info    : Used {r} registers, 100 bytes "
             "smem\n")
    name = 'corr_jac_flush<64, 256, 2> [corr_rows.cu]'
    for body in (spill + clean, clean + spill):
        r = ptxas.parse('== corr_rows.cu\n' + body)
        assert r[name]['spill_stores'] == 4 and r[name]['stack'] == 8
        assert ptxas.spills(r[name])
    r = ptxas.parse('== corr_rows.cu\n'
                    + entry.format(t='9TileShape', r=200)
                    + entry.format(t='8JacShape', r=90))
    assert r['corr_kernel<64, 256, 2, true>']['registers'] == 200
