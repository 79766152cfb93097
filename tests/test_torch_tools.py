"""The measurement scripts beside the port: ``kernel_report.py`` (ptxas's
registers and spills, the occupancy rules, the SASS attribution of K2's and
K9's tails and of K8's and K6's per-pixel parts, the default launches of
K7, K9, K8 and K6) and ``smoke_diff.py`` (the comparison of chip_smoke
runs), on synthetic inputs.  Both run their tools only on the card's machine; what
they parse is checked here."""

import json

import pytest

import kernel_report as kr
import smoke_diff as sd

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1kPf' for 'sm_90a'
ptxas info    : Function properties for _Z1kPf
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1gPf' for 'sm_90a'
ptxas info    : Function properties for _Z1gPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 380 bytes cmem[0]
"""


def test_ptxas_info_reads_registers_and_spills():
    info = kr.ptxas_info(PTXAS_LOG)
    assert info == {
        "_Z1kPf": {"stack_bytes": 8, "spill_store_bytes": 4,
                   "spill_load_bytes": 4, "registers": 64},
        "_Z1gPf": {"stack_bytes": 0, "spill_store_bytes": 0,
                   "spill_load_bytes": 0, "registers": 32}}


@pytest.mark.parametrize("regs,threads,smem,blocks", [
    (38, 128, 0, 12),        # registers: 48 warps of 40-register threads
    (32, 128, 0, 16),        # the 64-warp limit
    (64, 256, 0, 4),
    (89, 256, 36864, 2),     # 96 registers allocated a thread
    (16, 128, 100 * 1024, 2),   # shared memory
    (16, 32, 0, 32)])        # the 32-block limit
def test_blocks_per_sm_follows_the_occupancy_rules(regs, threads, smem,
                                                   blocks):
    assert kr.blocks_per_sm(regs, threads, smem) == blocks


SASS = """\
\t.section\t.text._Z1kPf,"ax",@progbits
.text._Z1kPf:
        /*0000*/                   LDS R2, [R3] ;
\t//## File "/r/csrc/rows3_tail.cuh", line 150
        /*0010*/                   FFMA R4, R2, R5, R4 ;
\t//## File "/r/csrc/tail.cuh", line 93 inlined at "/r/csrc/tail.cuh", line 98
\t//## File "/r/csrc/tail.cuh", line 98 inlined at "/r/csrc/rows3_tail.cuh", line 300
\t//## File "/r/csrc/rows3_tail.cuh", line 300
        /*0020*/                   MUFU.EX2 R6, R4 ;
        /*0030*/              @!P0 FMUL R6, R6, R6 ;
\t//## File "/r/csrc/tail.cuh", line 93 inlined at "/r/csrc/rows3_tail.cuh", line 200
\t//## File "/r/csrc/rows3_tail.cuh", line 200 inlined at "/r/csrc/rows3_tail.cuh", line 310
        /*0040*/                   MUFU.LG2 R7, R4 ;
\t//## File "/r/csrc/epilogue.cuh", line 60 inlined at "/r/csrc/rows3_tail.cuh", line 320
        /*0050*/                   FFMA R8, R7, R7, R7 ;
\t//## File "/r/csrc/rows3_tail.cuh", line 330
        /*0060*/                   STG.E.128 [R10], R8 ;
        /*0070*/                   FCHK P0, R1, R2 ;
        /*0080*/              @!P0 BRA `(.L_x_1) ;
\t.section\t.text._Z1gPf,"ax",@progbits
.text._Z1gPf:
        /*0000*/                   EXIT ;
"""


def test_sass_counts_attribute_the_tail_and_its_second_pass():
    counts = kr.sass_counts(SASS, ("rows3_tail.cuh", 190, 210))
    assert counts["_Z1kPf"] == {"instructions": 9, "branches": 1,
                                "fchk": 1, "tail": 4, "tail_mufu": 2,
                                "tail_second_pass": 1, "h_pass_ffma": 1}
    assert counts["_Z1gPf"]["instructions"] == 1
    assert kr.sass_counts(SASS)["_Z1kPf"]["tail_second_pass"] == 0


def test_sass_counts_attribute_a_parts_second_pass():
    """Given the second pass's lines, each part counts the instructions
    inlined through it too (K2's and K4's ``pow``): here the LG2 inlined
    through rows3_tail.cuh's lines 190-210 of the three pow instructions."""
    c = kr.sass_counts(SASS, ("rows3_tail.cuh", 190, 210),
                       {"pow": [("tail.cuh", 90, 95)]})["_Z1kPf"]
    assert c["parts"] == {"pow": {"instructions": 3, "mufu": 2,
                                  "second_pass": 1}}


def test_pow_part_of_k2_and_k4(tmp_path):
    """K2's and K4's ``pow`` part in this tree's tail.cuh: pow_pos,
    log2_normal, CheckedPow's body and both pow_of overloads; in a tree
    without the checked pow, pow_pos alone."""
    files, funcs = kr.PARTS["rows3_tail"]["pow"]
    assert kr.PARTS["mega3_tail"]["pow"] == (files, funcs)
    got = kr.function_lines(kr.build.CSRC, files, funcs)
    lines = (kr.build.CSRC / "tail.cuh").read_text().splitlines()
    heads = [lines[a - 1] for _, a, _ in got]
    assert len(got) == 5 and all(f == "tail.cuh" for f, _, _ in got)
    assert "pow_pos(" in heads[0] and "log2_normal(" in heads[1]
    assert heads[2].startswith("struct CheckedPow")
    assert all("pow_of(" in h for h in heads[3:])
    assert [lines[b - 1] for _, _, b in got] == ["}", "}", "};", "}", "}"]
    (tmp_path / "tail.cuh").write_text(
        "// t\n__device__ __forceinline__ float pow_pos(float x, float e) "
        "{\n  return x;\n}\n")
    assert kr.function_lines(tmp_path, files, funcs) == [("tail.cuh", 2, 4)]


def test_pow_part_and_second_pass_of_k8(tmp_path):
    """K8's LMS route (and K2's Dolby Vision route) take K2's ``pow`` part;
    their second pass is dovi_mid_group's block that runs a refused
    group's LMS steps again exactly and counts it; a tree without that
    block has none."""
    assert kr.PARTS["rows3_mid"]["pow"] == kr.PARTS["rows3_tail"]["pow"]
    assert kr.PARTS["rows3_tail_dovi"]["pow"] == kr.PARTS["rows3_tail"]["pow"]
    for prefix in ("rows3_mid", "rows3_tail_dovi"):
        assert kr.SECOND_PASS[prefix] is kr.lms_second_pass_lines
    assert "rows3_tail" not in kr.SECOND_PASS
    name, first, last = kr.lms_second_pass_lines(kr.build.CSRC)
    lines = (kr.build.CSRC / name).read_text().splitlines()
    assert name == "dovi_mid.cuh" and lines[first - 1] == "  if (!div.ok) {"
    body = "\n".join(lines[first - 1:last])
    assert "lms_lanes<1>(" in body and "count_redo(" in body
    assert lines[last - 1] == "  }"
    # the block lies inside dovi_mid_group
    (_, a, b), = kr.function_lines(kr.build.CSRC, ("dovi_mid.cuh",),
                                   ("dovi_mid_group",))
    assert a < first <= last < b
    assert kr.lms_second_pass_lines(tmp_path) == (None, 0, -1)


def test_k8_lms_parts_a_pixel_count_their_loops_pass(tmp_path):
    """K8's LMS route runs its LMS steps in a loop of kLmsLanes pixels a
    pass (read from this tree's dovi_mid.cuh), the rest of its convert 4
    pixels a pass: the LMS-step parts a pixel are their first pass over
    the loop's pixels, the whole convert its LMS steps so plus the rest
    over 4; without lanes every part counts over the group."""
    assert kr.lms_lanes(kr.build.CSRC) == 1
    assert kr.lms_lanes(tmp_path) is None
    (tmp_path / "dovi_mid.cuh").write_text("constexpr int kLmsLanes = 2;\n")
    assert kr.lms_lanes(tmp_path) == 2

    def parts():
        return {"mid": {"instructions": 1000, "mufu": 40, "second_pass": 100},
                "reshape": {"instructions": 400, "mufu": 0, "second_pass": 0},
                "lms": {"instructions": 500, "mufu": 24, "second_pass": 100},
                "pow": {"instructions": 300, "mufu": 24, "second_pass": 50}}

    p = parts()
    kr.parts_per_pixel(p, 4, 2)
    assert {k: c["per_pixel"] for k, c in p.items()} == {
        "mid": 500 / 4 + 400 / 2, "reshape": 100, "lms": 200, "pow": 125}
    assert p["mid"]["mufu_per_pixel"] == 16 / 4 + 24 / 2
    assert p["pow"]["mufu_per_pixel"] == 12
    p = parts()
    kr.parts_per_pixel(p, 4)
    assert {k: c["per_pixel"] for k, c in p.items()} == {
        "mid": 225, "reshape": 100, "lms": 100, "pow": 62.5}


def test_sass_digests_read_the_code_alone():
    """A function's SASS digest covers its instructions' text: the same
    code at other addresses and with other line information keeps it,
    another operand changes it."""
    d = kr.sass_digests(SASS)
    assert set(d) == {"_Z1kPf", "_Z1gPf"} and len(d["_Z1kPf"]) == 64
    moved = SASS.replace("/*0010*/", "/*0110*/").replace("line 150",
                                                         "line 151")
    assert kr.sass_digests(moved) == d
    other = kr.sass_digests(SASS.replace("FFMA R4, R2, R5, R4",
                                         "FFMA R4, R2, R6, R4"))
    assert other["_Z1kPf"] != d["_Z1kPf"] and other["_Z1gPf"] == d["_Z1gPf"]
    assert kr.sass_digests(SASS_K9)["_Z9cols3Pf"] == d["_Z1kPf"]
    # labels and subroutines numbered over the cubin: only their order in
    # the function counts
    calls = SASS.replace("(.L_x_1)", "(.L_x_7) ;\n        /*0090*/   "
                         "CALL.REL.NOINC `($__internal_3_$__cuda_div)")
    shifted = calls.replace(".L_x_7", ".L_x_12").replace("internal_3_",
                                                         "internal_5_")
    assert kr.sass_digests(shifted) == kr.sass_digests(calls) != d
    branch = SASS.replace("(.L_x_1) ;", "(.L_x_1) ;\n        /*0090*/   "
                          "BRA `(.L_x_{}) ;")
    assert kr.sass_digests(branch.format(2)) != kr.sass_digests(
        branch.format(1))
    # a return into the function names it: a kernel renamed by a parameter
    # it does not read keeps its digest
    ret = SASS.replace("EXIT ;", "RET.REL.NODEC R4 `({}) ;")
    renamed = ret.format("_Z1gPf").replace("_Z1gPf", "_Z1gPfPy")
    assert kr.sass_digests(renamed)["_Z1gPfPy"] == kr.sass_digests(
        ret.format("_Z1gPf"))["_Z1gPf"]
    assert kr.sass_digests(ret.format("_Z1kPf"))["_Z1gPf"] != \
        kr.sass_digests(ret.format("_Z1gPf"))["_Z1gPf"]


def test_second_pass_lines_find_tail_exact():
    name, first, last = kr.second_pass_lines(kr.build.CSRC)
    lines = (kr.build.CSRC / name).read_text().splitlines()
    assert "void tail_exact(" in lines[first - 1]
    assert lines[last - 1] == "}" and last > first
    assert kr.second_pass_lines(kr.ROOT) == (None, 0, -1)


SASS_K9 = SASS.replace("rows3_tail.cuh", "route.cuh").replace(
    "_Z1kPf", "_Z9cols3Pf")


def test_sass_counts_attribute_k9s_tail_through_route_cuh():
    """K9's kernel inlines the group tail and tail_exact from route.cuh:
    the same attribution, the second pass found there."""
    counts = kr.sass_counts(SASS_K9, ("route.cuh", 190, 210))
    assert counts["_Z9cols3Pf"] == {"instructions": 9, "branches": 1,
                                    "fchk": 1, "tail": 4, "tail_mufu": 2,
                                    "tail_second_pass": 1, "h_pass_ffma": 1}


SASS_K8 = """\
.text._Z3midPf:
\t//## File "/r/csrc/tail.cuh", line 99 inlined at "/r/csrc/rows3_mid.cuh", line 210
\t//## File "/r/csrc/rows3_mid.cuh", line 210 inlined at "/r/csrc/rows3_mid.cuh", line 400
\t//## File "/r/csrc/rows3_mid.cuh", line 400
        /*0000*/                   FMUL R1, R2, R3 ;
\t//## File "/r/csrc/tail.cuh", line 140 inlined at "/r/csrc/rows3_mid.cuh", line 220
\t//## File "/r/csrc/rows3_mid.cuh", line 220
        /*0010*/                   MUFU.LG2 R4, R1 ;
\t//## File "/r/csrc/rows3_mid.cuh", line 410
        /*0020*/                   FFMA R5, R4, R4, R5 ;
        /*0030*/                   STS.128 [R6], R4 ;
"""


def test_sass_counts_attribute_the_parts():
    """An instruction counts in a part when its location or any function it
    was inlined from lies in the part's line ranges: tail.cuh's helpers
    inlined into K8's convert count as ``mid``, the window's FFMA and
    store after it do not."""
    parts = {"mid": [("rows3_mid.cuh", 195, 225)],
             "none": [("jinc2.cuh", 1, 500)]}
    c = kr.sass_counts(SASS_K8, parts=parts)["_Z3midPf"]
    assert c["instructions"] == 4
    assert c["parts"] == {"mid": {"instructions": 2, "mufu": 1},
                          "none": {"instructions": 0, "mufu": 0}}
    assert "parts" not in kr.sass_counts(SASS_K8)["_Z3midPf"]


def test_function_lines_find_k8s_and_k6s_parts(tmp_path):
    """The parts' functions in this tree's sources (K8's convert in
    rows3_mid.cuh, K6's and K5's weights and resolve in jinc2.cuh, K5's
    quantization in epilogue.cuh) and in a tree that keeps K8's convert in
    rows3_mid.cu: each range starts at the function's signature and ends at
    its closing brace."""
    for part in (kr.PARTS["rows3_mid"]["mid"],
                 kr.PARTS["jinc2_convert"]["weights"],
                 kr.PARTS["jinc2_convert"]["resolve"],
                 kr.PARTS["jinc2_resize"]["quantize"]):
        files, funcs = part
        got = kr.function_lines(kr.build.CSRC, files, funcs)
        assert len(got) == len(funcs)
        for (name, first, last), fn in zip(got, funcs):
            lines = (kr.build.CSRC / name).read_text().splitlines()
            assert f"{fn}(" in lines[first - 1]
            assert lines[last - 1] == "}" and last > first
    (tmp_path / "rows3_mid.cu").write_text(
        "// k8\n__device__ float mmr(const float* w) {\n  return w[0];\n}\n"
        "__device__ void dovi_mid(float* c) {\n  mmr(c);\n}\n")
    assert kr.function_lines(tmp_path, ("rows3_mid.cuh", "rows3_mid.cu"),
                             ("dovi_mid", "mmr")) == [
        ("rows3_mid.cu", 5, 7), ("rows3_mid.cu", 2, 4)]
    assert kr.function_lines(tmp_path, ("jinc2.cuh",), ("jinc2_weight",)) \
        == []


def test_k8_convert_parts_in_this_tree_and_a_one_pixel_tree(tmp_path):
    """The parts of K8's convert: the reshape's functions, the RPU matrix
    and the LMS step as spans between two patterns (in dovi_mid and in the
    LMS route's dovi_mid_group alike), the divisions as ExactDiv's and
    CheckedDiv's operators in tail.cuh; a tree whose convert is dovi_mid
    alone (the one-pixel form) gives one span each."""
    parts = kr.PARTS["rows3_mid"]
    assert set(parts) == {"mid", "reshape", "rpu", "lms", "divisions", "pow"}
    assert kr.PARTS["rows3_tail_dovi"] == {
        "convert": parts["mid"], **{k: v for k, v in parts.items()
                                    if k != "mid"}}
    got = {p: kr.function_lines(kr.build.CSRC, *parts[p]) for p in parts}
    lines = (kr.build.CSRC / "dovi_mid.cuh").read_text().splitlines()
    for p in ("rpu", "lms"):
        assert len(got[p]) == 2 and all(f == "dovi_mid.cuh" and a <= b
                                        for f, a, b in got[p])
    for f, a, b in got["rpu"]:
        assert "P.vals + 4 * i" in lines[a - 1] and "m[3])" in lines[b - 1]
    for f, a, b in got["lms"]:
        assert "pq_to_linear(" in lines[a - 1]
        assert "linear_to_pq(" in "\n".join(lines[a - 1:b])
        assert "vrt::dot3(" in lines[b - 1]
    assert [f for f, _, _ in got["divisions"]] == ["tail.cuh", "tail.cuh"]
    tail = (kr.build.CSRC / "tail.cuh").read_text().splitlines()
    assert [tail[a - 1].split()[1] for _, a, _ in got["divisions"]] == [
        "ExactDiv", "CheckedDiv"]
    assert all(tail[b - 1] == "};" for _, _, b in got["divisions"])
    assert len(got["reshape"]) == 4
    (tmp_path / "dovi_mid.cuh").write_text(
        "// one pixel\n"
        "__device__ void dovi_mid(const float* v, float c[3]) {\n"
        "    const float* m = P.vals + 4 * i;\n"
        "    c[i] = add(vrt::dot3(m[0], m[1], m[2], y[0], y[1], y[2]), m[3]);\n"
        "  for (int i = 0; i < 3; ++i) x[i] = vrt::pq_to_linear(c[i], 1.f);\n"
        "    c[i] = vrt::linear_to_pq(\n"
        "        fmaxf(vrt::dot3(m[0], m[1], m[2], x[0], x[1], x[2]), 0.f));\n"
        "}\n")
    assert kr.function_lines(tmp_path, *parts["rpu"]) == [
        ("dovi_mid.cuh", 3, 4)]
    assert kr.function_lines(tmp_path, *parts["lms"]) == [
        ("dovi_mid.cuh", 5, 7)]
    assert kr.function_lines(tmp_path, ("dovi_mid.cuh",),
                             ((r"^never", r"^}"),)) == []


def test_part_group_option_comes_first():
    """--part-group NAME=N is matched before PART_GROUP's defaults, so a
    tree whose LMS route converts one pixel a thread reads per pixel."""
    lms = ("void vrt::k8::rows3_mid_kernel<vrt::dovi::MidRoute<1, -1>, "
           "unsigned short, float>()")
    c8 = lms.replace("MidRoute<1, -1>", "MidRoute<0, 1>")

    def group(groups, name):
        return next((v for k, v in groups.items() if k in name), 1)

    given = kr.part_groups(kr._pairs([kr.K8_LMS_ROUTE + "=1"], int))
    assert (group(given, lms), group(given, c8)) == (1, 4)
    assert (group(kr.part_groups({}), lms), group(kr.part_groups({}), c8)) \
        == (4, 4)


def test_part_groups_and_cells():
    """K8's c8 and LMS routes convert 4 pixels a pass (their demangled
    routes), its runtime route one, and so does K2's Dolby Vision route on
    every route; K6 and K5's table routes resolve 4 outputs a pass, K5's
    per-output routes and the one-output-a-thread K5 it replaced one; the
    cells are c8's mid pixels and p5's converts (K8), c8's source pixels
    (K2's Dolby Vision route), c3's outputs at batch 16 and c3r270's 48
    planes."""
    c8 = ("void vrt::k8::rows3_mid_kernel<vrt::dovi::MidRoute<(int)0, "
          "(int)1>, unsigned short, float>()").replace("(int)", "")
    lms = c8.replace("MidRoute<0, 1>", "MidRoute<1, -1>")
    k2 = c8.replace("k8::rows3_mid_kernel", "k2::rows3_tail_dovi_kernel")
    k2_lms = lms.replace("k8::rows3_mid_kernel", "k2::rows3_tail_dovi_kernel")
    grp = [next((v for k, v in kr.PART_GROUP.items() if k in n), 1)
           for n in (c8, lms, "void jinc2_convert_kernel<unsigned char, 1>",
                     "void (anonymous namespace)::jinc2_resize_kernel<1, 1>"
                     "(const float *)",
                     "void (anonymous namespace)::jinc2_resize_kernel<0, 1>"
                     "(const float *)",
                     "(anonymous namespace)::jinc2_resize_kernel("
                     "const float *, int)", k2, k2_lms)]
    assert grp == [4, 4, 4, 4, 1, 1, 4, 1]
    assert next((v for k, v in kr.PART_GROUP.items() if k in c8.replace(
        "MidRoute<0, 1>", "MidRoute<-1, -1>")), 1) == 1
    assert kr.PART_PIXELS == {"rows3_mid": {"c8": 16 * 2160 * 3840,
                                            "p5": 16 * 2160 * 3840 * 34 // 32},
                              "rows3_tail_dovi": {"c8": 16 * 2160 * 3840},
                              "jinc2_convert": {"c3": 16 * 2160 * 3840},
                              "jinc2_resize": {"c3r270": 48 * 2160 * 3840}}
    assert kr.PARTS["rows3_tail_dovi"]["convert"] == kr.PARTS["rows3_mid"][
        "mid"]
    assert kr.PARTS["rows3_mid"]["mid"][0][0] == "dovi_mid.cuh"
    assert set(kr.PARTS["jinc2_resize"]) == {"weights", "resolve",
                                             "quantize"}


def test_second_pass_lines_in_sources_without_route_cuh(tmp_path):
    """An older tree keeps tail_exact in rows3_tail.cuh: the report finds
    it there (kernel_report.py --csrc on the parent's sources)."""
    (tmp_path / "rows3_tail.cuh").write_text(
        "// k2\ntemplate <typename R>\nvoid tail_exact(int k) {\n  k;\n}\n")
    assert kr.second_pass_lines(tmp_path) == ("rows3_tail.cuh", 3, 5)


def test_default_launches_are_k7s_and_k9s_at_their_cells():
    """K4's and K10's kernels first (test_default_launches_of_k4_and_k10),
    then the long-window kernels (no shared memory), then K7's block at
    c5 (uint16), K9's c8 route at c8 and its other instantiations at c5
    (float32), K8's at c8, K2's Dolby Vision route at c8's stage A, K6's
    at c3, K5's at c3r270 and K3's on the letterbox's luma map: 256
    threads and the shared memory
    kernels/deint's, kernels/jinc2's and kernels/resize's formulas give,
    the c8 route matched first."""
    from videorenderer_tpu_torch.kernels import deint as dk
    got = dict(kr.default_launches())
    assert got[kr.LONG_WINDOW] == (256, 0)
    for name in ("void vrt::k2::rows3_tail_long_kernel<vrt::Route<-1, -1, "
                 "-1, -1, -1>, short, short>()",
                 "void vrt::k8::rows3_mid_long_kernel<vrt::k8::MidRoute<-1, "
                 "-1>, unsigned short, float>()",
                 "void deint3_long_kernel<unsigned short>()"):
        assert next(v for k, v in kr.default_launches() if k in name) \
            == (256, 0)
    assert [k for k, _ in kr.default_launches()] == [
        "mega3_tail_long_kernel", kr.K4_C7_ROUTE, "mega3_tail_kernel",
        "wpass_bf16_kernel", "wpass_floor_kernel",
        kr.LONG_WINDOW, "deint3_kernel", kr.C8_ROUTE, "cols3_tail_kernel",
        *kr.K8_HEAVY_ROUTES, "rows3_mid_kernel", "rows3_tail_dovi_kernel",
        "jinc2_convert_kernel", "jinc2_resize_kernel",
        "banded_resize_rows_kernel"]
    assert all(t == 256 for k, (t, _) in got.items()
               if k != "wpass_bf16_kernel")
    assert got["deint3_kernel"][1] == 62080
    assert got["rows3_mid_kernel"][1] == 69984
    assert got["rows3_tail_dovi_kernel"][1] == 19264
    # the LMS route at its 31-row tiles, the runtime route at 16
    assert [got[r][1] for r in kr.K8_HEAVY_ROUTES] == [68048, 36672]
    assert got["jinc2_convert_kernel"][1] == 4800
    assert got["jinc2_resize_kernel"][1] == 5760
    assert got["banded_resize_rows_kernel"][1] == 35712
    lms = ("void vrt::k8::rows3_mid_kernel<vrt::dovi::MidRoute<(int)1, "
           "(int)-1>, unsigned short, float>()").replace("(int)", "")
    assert next(v for k, v in kr.default_launches() if k in lms)[1] == 68048
    # K2's Dolby Vision route on the LMS route takes its own block
    k2_lms = lms.replace("k8::rows3_mid_kernel", "k2::rows3_tail_dovi_kernel")
    assert next(v for k, v in kr.default_launches() if k in k2_lms) \
        == got["rows3_tail_dovi_kernel"]
    assert 0 < got["cols3_tail_kernel"][1] < got[kr.C8_ROUTE][1] \
        <= dk.SMEM_BUDGET
    name = ("void vrt::k9::cols3_tail_kernel<vrt::Route<(int)0, (int)1, "
            "(int)0, (int)1, (int)1>, float, float>(const T2 *)")
    bare = name.replace("(int)", "")
    assert next(v for k, v in kr.default_launches() if k in bare) \
        == got[kr.C8_ROUTE]


def test_issue_bound_cells_of_k2_and_k9():
    assert kr.PIXELS["cols3_tail"] == {"c5": 32 * 1080 * 1920,
                                       "c8": 16 * 1080 * 1920}
    assert kr.PIXELS["rows3_tail"] == {"headline": 16 * 1080 * 1920,
                                       "c7": 16 * 2160 * 3840}
    assert kr.PIXELS["mega3_tail"] == kr.PIXELS["rows3_tail"]
    assert kr.GROUP == {"rows3_tail_kernel": 4, "cols3_tail_kernel": 4,
                        "mega3_tail": 4}


K4_K10_NAMES = {
    # demangled names as cu++filt spells them, "(int)" dropped
    "headline": ("void vrt::k4::mega3_tail_kernel<vrt::Route<1, 1, 0, 1, 0, "
                 "false>, unsigned short, unsigned short>(const T2 *)"),
    "c7": ("void vrt::k4::mega3_tail_kernel<vrt::Route<1, 0, 5, 1, 0, "
           "false>, unsigned short, unsigned short>(const T2 *)"),
    "long": ("void vrt::k4::mega3_tail_long_kernel<vrt::Route<-1, -1, -1, "
             "-1, -1, false>, unsigned short, unsigned short>(const T2 *)"),
    "wpass_bf16": "void (anonymous namespace)::wpass_bf16_kernel<true>()",
    "wpass_floor": "(anonymous namespace)::wpass_floor_kernel(const T1 *)"}


@pytest.mark.parametrize("name", list(K4_K10_NAMES))
def test_default_launches_of_k4_and_k10(name):
    """K4's staged kernel at the headline's layout (16-row tiles, three
    blocks an SM at 80 registers), its c7 route at c7's (64-row tiles), its
    long-window kernel at the 160 x 90 Lanczos thumbnail's chunks (two
    blocks an SM at 128 registers), K10's
    wpass_bf16 at 16 rows of the headline luma's span and wpass_floor with
    its 32 KB tile: 256 threads for K4 and wpass_floor, 128 for
    wpass_bf16, matched before the long-window entry."""
    from videorenderer_tpu_torch.kernels import resize as rk
    threads, smem = next(v for k, v in kr.default_launches()
                         if k in K4_K10_NAMES[name])
    want = {"headline": (256, 70848), "c7": (256, 45376),
            "wpass_bf16": (128, rk.k1_smem_bytes(2, 516, 16)),
            "wpass_floor": (256, 32768)}
    if name == "long":
        assert threads == 256 and 0 < smem <= rk.SMEM_BUDGET // 2 - 1024
    else:
        assert (threads, smem) == want[name]
    if name in ("headline", "c7"):
        assert kr.blocks_per_sm(80, threads, smem) == 3
    if name == "long":
        assert kr.blocks_per_sm(128, threads, smem) == 2


def _log(tmp_path, name, k2_digest="ab", psnr=76.0, ms=1.0):
    lines = [json.dumps({"phase": "device", "name": "card"}),
             json.dumps({"phase": "K2", "k2_digest": k2_digest,
                         "max_code_diff": 1, "ms": ms, "plain_ms": 9.0}),
             json.dumps({"phase": "c7", "psnr_db": {"scene0": psnr},
                         "digests": {"static": "cd"},
                         "ms_per_frame": 0.3}),
             json.dumps({"kernels": [{"name": "rows3_tail", "ms": ms,
                                      "max_abs_err": 0.001}]}),
             "NVIDIA H100 80GB HBM3, 700.00 W",
             json.dumps({"ok": True})]
    p = tmp_path / name
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def test_smoke_diff_equal_runs(tmp_path, capsys):
    base = [_log(tmp_path, "p1", ms=2.0), _log(tmp_path, "p2", ms=2.2)]
    new = [_log(tmp_path, "c1", ms=1.0), _log(tmp_path, "c2", ms=1.1)]
    assert sd.main(["--base", *base, "--new", *new]) == 0
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert out[0] == {"digests": {"equal": 2, "differing": []}}
    assert out[1]["accuracy"]["equal"] == 3
    k2 = out[2]["kernels"]["kernels/kernels/rows3_tail/ms"]
    assert k2["base"] == [2.0, 2.2] and k2["new"] == [1.0, 1.1]
    assert k2["new_over_base"] == pytest.approx(0.5)
    assert out[3]["times"]["K2/ms"]["new_mean"] == pytest.approx(1.05)


def test_smoke_diff_reports_a_changed_output(tmp_path, capsys):
    base = [_log(tmp_path, "p1")]
    new = [_log(tmp_path, "c1", k2_digest="ff", psnr=75.0)]
    assert sd.main(["--base", *base, "--new", *new]) == 1
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert out[0]["digests"]["differing"] == [
        {"key": "K2/k2_digest", "base": "ab", "other": "ff"}]
    assert out[1]["accuracy"]["differing"][0]["key"] == "c7/psnr_db/scene0"


@pytest.mark.parametrize("path,kind", [
    (("K1", "k1_digest", "mid16"), "digest"),
    (("probe", "stages", "c7", "digests", "tail"), "digest"),
    (("c5", "psnr_db_field0"), "accuracy"),
    (("kernels", "kernels", "rows3_tail", "max_abs_err"), "accuracy"),
    (("K2", "alpha_ok"), "accuracy"),
    (("K2", "plain_ms"), "time"),
    (("c5", "ms_per_field"), "time"),
    (("c7", "ms_batch1_median"), "time"),
    (("K2", "tolerance"), None)])
def test_smoke_diff_kinds(path, kind):
    assert sd.kind(path) == kind
