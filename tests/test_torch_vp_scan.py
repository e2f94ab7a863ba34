"""The VP pair scan's dispatch and checks, and its plain version's walk
up to the batch's largest candidate count, on the CPU.  The CUDA kernel
``lk_tpu_torch/csrc/vp_scan.cu`` is held to the plain version on the card
in tests/test_torch_cuda.py; here its argument block is held to the C
struct it fills."""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from lk_tpu_torch.geometry import vanishing
from vp_scan_cases import CANDS, STATES, same_bits, scan_case

torch.set_num_threads(1)

CU = (Path(vanishing.__file__).resolve().parents[1] / "csrc" / "vp_scan.cu")


def _leaves(result):
    state, out = result
    return dict(zip(vanishing.VPState._fields + vanishing.FrameGeomOut._fields,
                    (*state, *out)))


def test_a_cpu_call_takes_the_plain_version():
    cfg, state, cps, cand, size = scan_case("aliased", "mixed", 3, 40,
                                            seed=1)
    vanishing.reset_counters()
    got = vanishing.process_frame_pairs(state, cps, cand, cfg, size)
    assert vanishing.plain_calls == 1 and vanishing.kernel_launches == 0
    want = vanishing.process_frame_pairs_reference(state, cps, cand, cfg,
                                                   size)
    assert vanishing.plain_calls == 2
    for k, v in _leaves(got).items():
        assert same_bits(v, _leaves(want)[k]), k
    vanishing.reset_counters()
    assert vanishing.plain_calls == 0


def _bad(fault):
    """A case broken by ``fault``: (args, the error it must raise)."""
    cfg, state, cps, cand, size = scan_case("aliased", "mixed", 3, 40,
                                            seed=2)
    b, p = cand.shape
    if fault == "cps_dtype":
        return (state, cps.double(), cand, cfg, size), TypeError
    if fault == "cand_dtype":
        return (state, cps, cand.to(torch.uint8), cfg, size), TypeError
    if fault == "ring_total_dtype":
        state = state._replace(ring_total=state.ring_total.int())
        return (state, cps, cand, cfg, size), TypeError
    if fault == "vp_init_dtype":
        state = state._replace(vp_init=state.vp_init.to(torch.uint8))
        return (state, cps, cand, cfg, size), TypeError
    if fault == "cps_shape":
        return (state, torch.zeros(b, p, 3), cand, cfg, size), ValueError
    if fault == "cand_shape":
        return (state, cps, cand[:, :-1], cfg, size), ValueError
    if fault == "ring_shape":
        state = state._replace(ring_xy=state.ring_xy[:, :-1])
        return (state, cps, cand, cfg, size), ValueError
    if fault == "hist_shape":
        state = state._replace(hist_xy=state.hist_xy[:, :-1])
        return (state, cps, cand, cfg, size), ValueError
    if fault == "alias_pos_shape":
        state = state._replace(alias_pos=state.alias_pos[:, None])
        return (state, cps, cand, cfg, size), ValueError
    if fault == "batch":
        state = state._replace(vp_xy=torch.zeros(b + 1, 2))
        return (state, cps, cand, cfg, size), ValueError
    if fault == "device":
        meta = vanishing.VPState(*(x.to("meta") for x in state))
        return (meta, cps.to("meta"), cand.to("meta"), cfg, size), ValueError
    if fault == "mixed_devices":
        meta = vanishing.VPState(*(x.to("meta") for x in state))
        return (meta, cps, cand, cfg, size), ValueError
    raise AssertionError(fault)


@pytest.mark.parametrize("fault", [
    "cps_dtype", "cand_dtype", "ring_total_dtype", "vp_init_dtype",
    "cps_shape", "cand_shape", "ring_shape", "hist_shape", "alias_pos_shape",
    "batch", "device", "mixed_devices"])
def test_the_scan_rejects_what_it_does_not_take(fault):
    args, error = _bad(fault)
    vanishing.reset_counters()
    with pytest.raises(error):
        vanishing.process_frame_pairs(*args)
    assert vanishing.plain_calls == 0 and vanishing.kernel_launches == 0


@pytest.mark.parametrize("cand_kind", CANDS)
@pytest.mark.parametrize("state_kind", STATES)
def test_steps_past_the_candidates_change_nothing(state_kind, cand_kind):
    """The plain version walks the batch up to its largest candidate
    count: each stream's scan gives the same bits alone (B = 1, its own
    count) and in a batch beside a stream with a candidate in every pair,
    and the input state is left as it was."""
    cfg, state, cps, cand, size = scan_case(state_kind, cand_kind, 4, 60,
                                            seed=3)
    _, full, full_cps, full_cand, _ = scan_case(state_kind, "all", 1, 60,
                                                seed=4)
    batch = (vanishing.VPState(*(torch.cat(x) for x in zip(state, full))),
             torch.cat([cps, full_cps]), torch.cat([cand, full_cand]))
    before = [x.clone() for x in (*batch[0], *batch[1:])]
    together = _leaves(vanishing.process_frame_pairs_reference(
        *batch, cfg, size))
    assert all(same_bits(a, b)
               for a, b in zip(before, (*batch[0], *batch[1:])))
    p = cand.shape[1]
    assert int(full_cand.sum()) == p
    assert (cand_kind == "all") == bool((cand.sum(dim=1) == p).all())
    for i in range(cand.shape[0]):
        one = vanishing.VPState(*(x[i:i + 1] for x in state))
        alone = _leaves(vanishing.process_frame_pairs_reference(
            one, cps[i:i + 1], cand[i:i + 1], cfg, size))
        for k, v in alone.items():
            assert same_bits(v, together[k][i:i + 1]), (i, k)
    if cand_kind == "none":
        assert not together["cp_mask"][:-1].any()
        assert not together["update_mask"][:-1].any()
    else:
        assert together["cp_mask"][:-1].any()


def test_the_argument_block_matches_the_c_struct():
    """``_ScanArgs`` lists ``LkVpScanArgs``'s fields in its order with
    their C types' sizes (the kernel cannot be built here)."""
    body = re.search(r"struct LkVpScanArgs \{(.*?)\n\};", CU.read_text(),
                     re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        ctype, names = re.fullmatch(r"(.+?[\s*])(\w+(?:, \w+)*);",
                                    line).groups()
        kind = ("pointer" if "*" in ctype else ctype.strip())
        fields += [(n, kind) for n in names.split(", ")]
    want = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
            ctypes.c_float: "float"}
    assert fields == [(n, want[t]) for n, t in vanishing._ScanArgs._fields_]
    assert ctypes.sizeof(vanishing._ScanArgs) == 27 * 8 + 5 * 4 + 5 * 4
