"""The SHA-256 and gear kernels' bounds as ``chip_smoke.py`` computes them,
and their SASS as it reads it, on the CPU: the functions' work by pipe, the
bound formulas, the loop finders and the opcode classifier, held against
values worked out by hand and short ``cuobjdump -sass`` excerpts written
here. Nothing here needs the card."""

import pytest
import torch

import chip_smoke as cs


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # As in test_torch_sha256.py: this module competes for no core with the
    # timing-band tests that run beside it under pytest-xdist.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _listing(functions: dict[str, list[str]]) -> str:
    """A ``cuobjdump -sass`` listing: each function's instructions at
    addresses 16 apart from 0, each followed by its encoding line."""
    out = ["", "Fatbin elf code:", "================", "arch = sm_90a", ""]
    for name, body in functions.items():
        out.append(f"\t\tFunction : _ZN12_GLOBAL__N_1{len(name)}{name}EPKhPKlS3_lPi")
        out.append("\t.headerflags\t@\"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)\"")
        for i, ins in enumerate(body):
            out.append(f"        /*{16 * i:04x}*/                   {ins} ;"
                       "                 /* 0x000fe20000000f00 */")
            out.append("                                                       "
                       "                /* 0x000fe40000000f00 */")
        out.append("\t\t..........")
    return "\n".join(out)


# The shape of sha256_rows_kernel: the 4-byte aligned path's loop (0x40 to
# 0xa0) before the ring's loop (0xc0 to 0x140), which is longer, and the
# trailing self-branch. Then another kernel with a loop of its own.
ROWS = [
    "S2R R0, SR_TID.X",                                   # 0x00
    "ISETP.GE.U32.AND P0, PT, R0, UR4, PT",               # 0x10
    "@P0 EXIT",                                           # 0x20
    "BSSY B0, 0x160",                                     # 0x30
    "LDG.E.CONSTANT R4, desc[UR4][R2.64]",                # 0x40  4-byte loop
    "PRMT R4, R4, 0x123, RZ",                             # 0x50
    "SHF.R.W.U32.HI R5, R4, 0x6, R4",                     # 0x60
    "LOP3.LUT R6, R5, R7, R8, 0x96, !PT",                 # 0x70
    "IADD3 R9, P1, R2, 0x40, RZ",                         # 0x80
    "@!P0 BRA 0x40",                                      # 0x90
    "IMAD.IADD R10, R9, 0x1, R6",                         # 0xa0
    "BSYNC B0",                                           # 0xb0
    "DEPBAR.LE SB0, 0x1",                                 # 0xc0  ring loop
    "LDS.128 R12, [R3]",                                  # 0xd0
    "PRMT R12, R12, 0x123, RZ",                           # 0xe0
    "IMAD.MOV.U32 R13, RZ, RZ, R12",                      # 0xf0
    "@!P0 LDGSTS.E.BYPASS.128 [R3+0x800], desc[UR4][R2.64]",  # 0x100
    "LDGDEPBAR",                                          # 0x110
    "IADD3 R14, R13, R12, R11",                           # 0x120
    "ISETP.GE.U32.AND P0, PT, R14, UR5, PT",              # 0x130
    "@!P0 BRA 0xc0",                                      # 0x140
    "EXIT",                                               # 0x150
    "BRA 0x160",                                          # 0x160
]
OTHER = [
    "IADD3 R1, R2, R3, R4",                               # 0x00
    "LOP3.LUT R1, R1, R2, R3, 0x96, !PT",                 # 0x10
    "SHF.L.U32 R1, R1, 0x2, RZ",                          # 0x20
    "IADD3 R1, R1, R2, R3",                               # 0x30
    "BRA 0x0",                                            # 0x40
]
SASS = _listing({"sha256_rows_kernel": ROWS, "gear_candidates_kernel": OTHER})


@pytest.mark.parametrize(
    "instruction, pipe",
    [
        ("IADD3 R9, P1, R2, 0x40, RZ", "alu"),
        ("IADD3.X R5, RZ, R5, RZ, P1, !PT", "alu"),
        ("LOP3.LUT R6, R5, R7, R8, 0x96, !PT", "alu"),
        ("SHF.R.W.U32.HI R5, R4, 0x6, R4", "alu"),
        ("SHF.R.U32.HI R5, RZ, 0x3, R4", "alu"),
        ("PRMT R4, R4, 0x123, RZ", "alu"),
        ("ISETP.GE.U32.AND.EX P0, PT, R5, R22, PT, P0", "alu"),
        ("@!P0 SEL R1, R2, R3, P1", "alu"),
        ("LEA R2, P0, R0, UR4, 0x6", "alu"),
        ("MOV R1, R2", "alu"),
        ("IMAD.IADD R10, R9, 0x1, R6", "fma"),
        ("IMAD.MOV.U32 R13, RZ, RZ, R12", "fma"),
        ("IMAD.SHL.U32 R2, R0, 0x4, RZ", "fma"),
        ("IMAD.WIDE.U32 R2, R0, 0x40, R2", "fma"),
        ("IMAD.HI.U32 R1, R2, c[0x3][0x10], RZ", "fma"),
        ("LDG.E.128.CONSTANT R4, desc[UR4][R2.64]", "other"),
        ("@!P0 LDGSTS.E.BYPASS.128 [R3+0x800], desc[UR4][R2.64]", "other"),
        ("LDS.128 R12, [R3]", "other"),
        ("DEPBAR.LE SB0, 0x1", "other"),
        ("@!P0 BRA 0xc0", "other"),
        ("VIADD R13, R12, 0x428a2f98", "alu"),
        ("VIMNMX3.U32 R50, R27, R12, R0, PT", "alu"),
        ("BAR.SYNC.DEFER_BLOCKING R16, 0x40", "other"),
        ("STS.128 [R30], R12", "other"),
        ("UIADD3 UR4, UR4, 0x1, URZ", "other"),
        ("EXIT", "other"),
    ],
)
def test_pipe_of_classifies_each_opcode(instruction, pipe):
    assert cs.pipe_of(instruction) == pipe


def test_sass_function_reads_one_kernel_only():
    ins = cs.sass_function(SASS, "sha256_rows_kernel")
    assert [a for a, _ in ins] == [16 * i for i in range(len(ROWS))]
    assert [t for _, t in ins] == ROWS
    assert cs.sass_instructions(SASS, "gear_candidates_kernel") == len(OTHER)
    assert cs.sass_function(SASS, "sha256_packed_kernel") == []


def test_sass_loops_are_each_backward_branch_and_its_body():
    loops = cs.sass_loops(cs.sass_function(SASS, "sha256_rows_kernel"))
    assert loops == [ROWS[4:10], ROWS[12:21], ROWS[22:23]]


def test_block_loop_takes_the_ring_loop_over_a_smaller_one():
    # The 4-byte path's loop (6 instructions) is smaller, but the ring's
    # (9, with the LDGSTS copies) is the main path's.
    assert cs.block_loop(SASS, "sha256_rows_kernel", min_len=4) == ROWS[12:21]


def test_block_loop_needs_exactly_one_ring_loop():
    no_ring = [ins.replace("@!P0 LDGSTS.E.BYPASS.128 [R3+0x800], desc[UR4][R2.64]", "NOP")
               for ins in ROWS]
    with pytest.raises(ValueError, match="0 ring loops"):
        cs.block_loop(_listing({"sha256_rows_kernel": no_ring}), "sha256_rows_kernel", min_len=4)
    two_rings = [ins.replace("PRMT R4, R4, 0x123, RZ", "LDGSTS.E [R3], desc[UR4][R2.64]")
                 for ins in ROWS]
    with pytest.raises(ValueError, match="2 ring loops"):
        cs.block_loop(_listing({"sha256_rows_kernel": two_rings}), "sha256_rows_kernel",
                      min_len=4)


def test_block_loop_needs_a_loop_of_min_len():
    # The default threshold (a schedule's or a compression's worth)
    # excludes these loops.
    with pytest.raises(ValueError, match="sha256_rows_kernel"):
        cs.block_loop(SASS, "sha256_rows_kernel")
    with pytest.raises(ValueError, match="sha256_packed_kernel"):
        cs.block_loop(SASS, "sha256_packed_kernel", min_len=1)


def test_block_loop_at_the_default_threshold():
    body = ["LDS.128 R12, [R3]"] + ["LOP3.LUT R6, R5, R7, R8, 0x96, !PT"] * 150 + [
        "IMAD.IADD R10, R9, 0x1, R6"] * 120 + ["LDGSTS.E [R3], desc[UR4][R2.64]"]
    sass = _listing({"sha256_packed_kernel": body + ["@!P0 BRA 0x0", "EXIT"]})
    loop = cs.block_loop(sass, "sha256_packed_kernel")
    assert len(loop) == 273 >= cs.MIN_BLOCK_LOOP
    assert cs.pipe_counts(loop) == {"alu": 150, "fma": 120, "other": 3}


def test_pipe_counts_of_the_ring_loop():
    loop = cs.block_loop(SASS, "sha256_rows_kernel", min_len=4)
    # PRMT, IADD3, ISETP; IMAD.MOV; DEPBAR, LDS, LDGSTS, LDGDEPBAR, BRA.
    assert cs.pipe_counts(loop) == {"alu": 3, "fma": 1, "other": 5}


def test_sha_work_a_block_counted_by_hand():
    # A round: 6 rotates and 4 three-input logic ops (two xors of three
    # rotates, Ch, Maj); 4 adds. A schedule step: 4 rotates, 2 shifts and 2
    # xors; 2 adds. 8 state adds a block, 16 byte swaps a natural block.
    assert cs.SHA_ROUNDS == {"alu": 640, "either": 264}
    assert cs.SHA_SCHEDULE == {"alu": 384, "either": 96}
    assert cs.SHA_BLOCK[cs.ROWS_KERNEL] == {"alu": 1040, "either": 360}
    assert cs.SHA_BLOCK[cs.PACKED_KERNEL] == {"alu": 1024, "either": 360}


@pytest.mark.parametrize(
    "work, chain, throughput",
    [
        # The rounds: ALU-bound, 2 clocks an ALU-only instruction for one
        # warp; 640 / 64 lanes an SM when full.
        (cs.SHA_ROUNDS, 1280, 640 / 64),
        # A natural row's block: 1,040 ALU-only of 1,400.
        (cs.SHA_BLOCK[cs.ROWS_KERNEL], 2080, 1040 / 64),
        # Issue-bound: the adds fill the FMA pipe while the ALU-only
        # instructions hold the ALU pipe, so a warp issues one a clock and
        # an SM four warps' (1,500 / 128).
        ({"alu": 500, "either": 1000}, 1500, 1500 / 128),
        ({"alu": 0, "either": 10}, 10, 10 / 128),
    ],
)
def test_chain_and_throughput_cycles(work, chain, throughput):
    assert cs.chain_cycles(work) == chain
    assert cs.throughput_cycles(work) == pytest.approx(throughput)


def test_sha_bounds_at_the_main_shape_is_the_chain():
    # 64 rows of 4 MiB: 65,537 blocks a row (65,536 and the padding).
    blocks, longest, nbytes = cs.rows_work([4 << 20] * 64)
    assert (blocks, longest, nbytes) == (64 * 65537, 65537, 64 * (4 << 20) + 64 * 48)
    b = cs.sha_bounds(cs.ROWS_KERNEL, blocks, longest, nbytes, sms=132, clock_hz=1.98e9)
    chain = 65537 * 1280 / 1.98e9 * 1e3  # 42.367 ms
    thr = 64 * 65537 * (1040 / 64) / 132 / 1.98e9 * 1e3  # 0.261 ms
    byt = (64 * (4 << 20) + 64 * 48) / 3.35e12 * 1e3  # 0.080 ms
    assert b["chain_bound_ms"] == pytest.approx(chain)
    assert b["throughput_bound_ms"] == pytest.approx(thr)
    assert b["bytes_bound_ms"] == pytest.approx(byt)
    assert b["bound_ms"] == pytest.approx(42.367, abs=1e-3)
    assert b["bound_by"] == "operations"


def test_sha_bounds_at_the_full_card_is_the_throughput():
    # 132 x 1024 rows of 64 KiB: 1,025 blocks a row.
    blocks, longest, nbytes = cs.rows_work([64 << 10] * (132 * 1024))
    b = cs.sha_bounds(cs.ROWS_KERNEL, blocks, longest, nbytes, sms=132, clock_hz=1.98e9)
    assert b["bound_ms"] == b["throughput_bound_ms"] == pytest.approx(
        132 * 1024 * 1025 * 1040 / 64 / 132 / 1.98e9 * 1e3)  # 8.614 ms
    assert b["chain_bound_ms"] == pytest.approx(1025 * 1280 / 1.98e9 * 1e3)  # 0.663 ms
    assert b["bound_by"] == "operations"
    # The packed kernel's block has no byte swaps.
    p = cs.sha_bounds(cs.PACKED_KERNEL, *cs.packed_work(132 * 1024, 1024), sms=132,
                      clock_hz=1.98e9)
    assert p["throughput_bound_ms"] == pytest.approx(b["throughput_bound_ms"] * 1024 / 1040)
    assert p["chain_bound_ms"] == pytest.approx(b["chain_bound_ms"])


def test_sha_bounds_never_below_the_bytes():
    b = cs.sha_bounds(cs.ROWS_KERNEL, 1024, 1, 1 << 30, sms=132, clock_hz=1.98e9)
    assert b["bound_ms"] == b["bytes_bound_ms"] == pytest.approx((1 << 30) / 3.35e12 * 1e3)
    assert b["bound_by"] == "bytes"


# The fastest time each shape has run in on the card, by any variant of the
# kernels (NVIDIA H100 80GB HBM3, 700 W, SM clock 1980 MHz; PERF.md): a
# bound is the least time the card could take, so none may sit above one.
MEASURED = [
    # A schedule warp beside each rounds warp: 64 x 4 MiB rows, 66.95 ms.
    (cs.ROWS_KERNEL, cs.rows_work([4 << 20] * 64), 66.95),
    (cs.PACKED_KERNEL, cs.packed_work(1024, 65536), 61.88),
    (cs.ROWS_KERNEL, cs.rows_work([256 << 10] * 1024), 4.252),
    (cs.PACKED_KERNEL, cs.packed_work(1024, 4096), 3.896),
    # The block ring alone, at the full card.
    (cs.ROWS_KERNEL, cs.rows_work([64 << 10] * (132 * 1024)), 11.240),
    (cs.PACKED_KERNEL, cs.packed_work(132 * 1024, 1024), 11.221),
]


@pytest.mark.parametrize("kernel, work, ms", MEASURED)
def test_sha_bounds_below_every_measured_time(kernel, work, ms):
    assert cs.sha_bounds(kernel, *work, sms=132, clock_hz=1.98e9)["bound_ms"] < ms


@pytest.mark.parametrize(
    "lengths, blocks, longest",
    [
        ([0], 1, 1),
        ([55], 1, 1),
        ([56], 2, 2),
        ([64], 2, 2),
        ([119, 120], 2 + 3, 3),
        ([16 * 1024 + 63, 12_345], 258 + 194, 258),
    ],
)
def test_rows_work_counts_blocks_with_padding(lengths, blocks, longest):
    assert cs.rows_work(lengths) == (blocks, longest, sum(lengths) + 48 * len(lengths))


def test_card_bound_keeps_its_signature():
    # chip_sha256_sweep.py calls Card().bound(lengths) -> (ms, bound_by).
    card = cs.Card.__new__(cs.Card)
    card.sms, card.sm_clock_hz = 132, 1.98e9
    ms, by = card.bound([4 << 20] * 64)
    assert (ms, by) == (pytest.approx(65537 * 1280 / 1.98e9 * 1e3), "operations")
    # A packed 4 MiB piece's chain is a 4 MiB row's: 65,536 blocks and the
    # padding block.
    b = card.sha_bound(cs.PACKED_KERNEL, *cs.packed_work(1024, 65536))
    assert b["chain_bound_ms"] == pytest.approx(ms)


def test_packed_work_counts_the_padding_block():
    assert cs.packed_work(1024, 1) == (2048, 2, 1024 * 64 + 1024 * 32)
    assert cs.packed_work(2048, 8) == (2048 * 9, 9, 2048 * 8 * 64 + 2048 * 32)


# The shape of gear_candidates_kernel: the table's fill loop, the warm-up,
# then the step loop (0x80 to 0x1c0): the next step's loads, a run body cut
# short, the vote and a forward branch over the rare path (0x120 to 0x170,
# with the atomic) to the loop's tail; a divergence fallback outside it.
GEAR = [
    "STS [R3], R4",                                       # 0x00
    "@P0 BRA 0x0",                                        # 0x10  fill loop
    "BAR.SYNC.DEFER_BLOCKING 0x0",                        # 0x20
    "LDG.E.U8 R2, desc[UR6][R2.64]",                      # 0x30
    "REDUX.SUM UR4, R2",                                  # 0x40
    "LDG.E.128.CONSTANT R12, desc[UR6][R36.64]",          # 0x50
    "LDG.E.128.CONSTANT R8, desc[UR6][R36.64+0x10]",      # 0x60
    "ISETP.GE.U32.AND P0, PT, R0, R15, PT",               # 0x70
    "@!P0 LDG.E.128.CONSTANT R4, desc[UR6][R2.64+0x400]",  # 0x80  step loop
    "PRMT R19, R12, 0x4440, RZ",                          # 0x90
    "LEA R19, R19, R20, 0x7",                             # 0xa0
    "LDS R19, [R19]",                                     # 0xb0
    "IMAD R21, R21, 0x2, R19",                            # 0xc0
    "BRA.DIV UR5, 0x1f0",                                 # 0xd0
    "SHFL.UP PT, R50, R27, 0x1, RZ",                      # 0xe0
    "VIMNMX3.U32 R50, R27, R12, R0, PT",                  # 0xf0
    "VOTE.ANY P0, !P0",                                   # 0x100
    "@!P0 BRA 0x180",                                     # 0x110
    "POPC R3, R2",                                        # 0x120 rare path
    "SHFL.UP PT, R33, R32, 0x1, RZ",                      # 0x130
    "@!P1 ATOMG.E.ADD.STRONG.GPU PT, R75, desc[UR6][R2.64], R33",  # 0x140
    "STG.E [R4.64], R5",                                  # 0x150
    "@P2 BRA 0x150",                                      # 0x160
    "NOP",                                                # 0x170
    "IADD3 R0, P1, R19, 0x400, RZ",                       # 0x180 loop tail
    "ISETP.GE.U32.AND P0, PT, R0, R15, PT",               # 0x190
    "IMAD.X R3, RZ, RZ, R17, P1",                         # 0x1a0
    "MOV R12, R4",                                        # 0x1b0
    "@!P0 BRA 0x80",                                      # 0x1c0
    "EXIT",                                               # 0x1d0
    "BRA 0x1e0",                                          # 0x1e0
    "WARPSYNC.COLLECTIVE R11, 0x200",                     # 0x1f0 divergence fallback
    "BRA 0xe0",                                           # 0x200
]


def test_gear_run_body_is_the_step_loop_without_the_rare_path():
    sass = _listing({"gear_candidates_kernel": GEAR})
    body = cs.gear_run_body(sass)
    # The step loop (0x80-0x1c0) less what its vote's branch skips (0x120-0x170);
    # the divergence fallback's back-branch starts later, the fill loop loads no 16 bytes.
    assert body == GEAR[8:18] + GEAR[24:29]
    # PRMT, LEA, VIMNMX3, IADD3, ISETP, MOV; IMAD, IMAD.X; the loads, the
    # shuffle, the vote and the three branches.
    assert cs.pipe_counts(body) == {"alu": 6, "fma": 2, "other": 7}
    assert cs.gear_sass_per_byte(sass) == {"alu": 6 / 32, "fma": 2 / 32, "other": 7 / 32}
    with pytest.raises(ValueError, match="no loop"):
        cs.gear_run_body(_listing({"gear_candidates_kernel": GEAR[:8] + GEAR[29:]}))


def test_gear_work_a_byte_counted_by_hand():
    # The lookup form: per byte, PRMT and half a 3-input min on the ALU pipe,
    # the table address and the shift-add on either, one shared-memory
    # load. Its busiest leg is the issue slots: 4.5 / 128 clocks a byte.
    assert cs.GEAR_WORK == {"alu": 1.5, "either": 2, "lds": 1}
    assert cs.throughput_cycles(cs.GEAR_WORK) == pytest.approx(4.5 / 128)
    # The map computed arithmetically (two shifts and two xors, two
    # multiplies) with the shift-add and a min: 5 / 64 on the ALU pipe.
    arithmetic = {"alu": 5, "fma": 2, "either": 1}
    assert cs.throughput_cycles(arithmetic) == pytest.approx(5 / 64)
    assert cs.throughput_cycles(cs.GEAR_WORK) < cs.throughput_cycles(arithmetic)
    # Shared-memory loads alone: 32 lanes an SM a clock.
    assert cs.throughput_cycles({"alu": 0, "either": 0, "lds": 64}) == pytest.approx(2)


def test_gear_bounds_at_the_main_window_are_the_bytes():
    win = 64 << 20
    b = cs.gear_bounds(win, win + 31 + 4 * 4097, sms=132, clock_hz=1.98e9)
    assert b["bytes_bound_ms"] == pytest.approx((win + 31 + 4 * 4097) / 3.35e12 * 1e3)
    assert b["ops_bound_ms"] == pytest.approx(win * 4.5 / 128 / 132 / 1.98e9 * 1e3)  # 0.0090 ms
    assert b["bound_ms"] == b["bytes_bound_ms"] == pytest.approx(0.02004, abs=1e-5)
    assert b["bound_by"] == "bytes"
    # The arithmetic form's 5 / 64 clocks a byte: 0.0201 ms, a hair above.
    assert win * (5 / 64) / 132 / 1.98e9 * 1e3 == pytest.approx(0.02006, abs=1e-5)


def test_gear_bound_below_every_measured_time():
    # The fastest time a 64 MiB window has run in on the card, by any build
    # of the kernel (NVIDIA H100 80GB HBM3, 700 W, SM clock 1980 MHz,
    # queued; PERF.md): 0.02898 ms, the table map as shipped.
    win = 64 << 20
    assert cs.gear_bounds(win, win + 31, sms=132, clock_hz=1.98e9)["bound_ms"] < 0.02898
