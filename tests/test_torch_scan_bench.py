"""The host-side arithmetic of ``launch/scan_bench.py`` (K4's and K8's
latency floors and probe sizes); the probes themselves run on the card."""
import pytest

from repro_torch.launch import scan_bench as sb


@pytest.mark.parametrize("H,sms,want", [(650, 132, (5, 130)), (512, 132, (4, 128)),
                                        (1500, 132, (12, 125)), (40, 132, (1, 40))])
def test_first_grid_is_ceil_H_over_SMs_units_a_CTA(H, sms, want):
    assert sb.first_grid(H, sms) == want


def test_floor_is_T_times_the_cheapest_probe_per_step():
    per_step = {"a": 1.9, "b": 1.5, "c": 40.0}
    assert sb.floor_ms(per_step, 35) == pytest.approx(1.5 * 35 / 1e3)
    assert sb.floor_ms(per_step, 50, exchanges=3) == pytest.approx(1.5 * 50 * 3 / 1e3)


@pytest.mark.parametrize("B,H,k", [(20, 650, 325), (64, 512, 358)])
def test_probe_cases_move_the_kernels_words(B, H, k):
    """all_dgates: each CTA reads all B x 4H dgates words; column_owned: B x k
    partial sums out, B x J from every CTA in; clusters of 8: P x 8 CTAs, a
    DSMEM gather of B x 4J from each, B x k / 8 out, B x J from each of the P
    CTAs of a column in."""
    cases = sb.probe_cases(B, H, k, 132, 15)
    J, N = sb.first_grid(H, 132)
    which, n, gmod, pub, rd, dsm = cases["c_tagged_all_dgates"]
    assert (which, n, gmod) == (2, N, 1) and rd * N >= B * 4 * H and pub == rd == B * 4 * J
    which, n, gmod, pub, rd, dsm = cases["c_tagged_column_owned"]
    assert (pub, rd) == (B * k, B * J)
    which, n, gmod, pub, rd, dsm = cases["d_cluster_dsmem"]
    assert which == 3 and gmod == 8 and n % 8 == 0 and n // 8 <= 15
    Jc = dsm // (4 * B)
    assert n * Jc >= H > (n - 8) * Jc and rd == B * Jc and pub == -(-B * k // 8)
    assert {c[0] for c in cases.values()} == {0, 1, 2, 3}


def test_k4_ops_are_bp_and_wg_on_the_tensor_cores():
    """BP and WG, 2 B k 4H FLOPs a step each at the kept units, three TF32
    products each (3xTF32); nothing counted on FFMA."""
    T, B, H, k = 35, 20, 650, 325
    assert sb.k4_bwd_ops(T, B, H, k) == {"tf32": 3 * T * 2 * (2 * B * k * 4 * H), "f32": 0}


@pytest.mark.parametrize("kept", [[358] * 4, [512, 358, 100, 0]])
def test_k8_ops_split_the_tensor_core_products_from_the_ffma_rest(kept):
    """The split keeps the whole count (4 B k 4H a site, five attention
    products of 2 B S H and two readout products of 2 B 2H H a step): the
    readout's dpre @ w_comb^T and three attention products on FFMA, the
    rest three times over on the TF32 tensor cores."""
    T, B, S, H = 50, 64, 50, 512
    ops = sb.k8_bwd_ops(T, B, S, H, kept)
    att, ro = 2 * B * S * H, 2 * B * 2 * H * H
    assert ops["f32"] == T * (3 * att + ro)
    assert ops["tf32"] % 3 == 0
    assert ops["tf32"] // 3 + ops["f32"] == T * (sum(4 * B * k * 4 * H for k in kept)
                                                 + 5 * att + 2 * ro)
