"""The host-side arithmetic of ``launch/scan_bench.py`` (K3's, K4's, K7's
and K8's latency floors, probe sizes and operation counts); the probes
themselves run on the card."""
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


@pytest.mark.parametrize("B,H,k", [(20, 650, 325), (64, 512, 358), (64, 512, 716)])
def test_fwd_probe_cases_move_the_forwards_words(B, H, k):
    """The first forward's grid reads all B x k inputs (by __ldcg, or as
    tagged words from every CTA); clusters of Q poll B x k / Q words from
    the P CTAs of a column and gather B x k / Q floats (gather form) or
    B x 4J partial gates (partial-sum form) from each of the Q CTAs."""
    cases = sb.fwd_probe_cases(B, H, k, 132, {8: 15, 4: 30})
    J, N = sb.first_grid(H, 132)
    assert cases["a_grid_sync"][:2] == (0, N) and cases["b_l2_barrier"][:2] == (1, N)
    which, n, gmod, pub, rd, dsm = cases["c_ldcg_all_inputs"]
    assert (which, n, rd) == (4, N, B * k)
    which, n, gmod, pub, rd, dsm = cases["d_tagged_broadcast"]
    assert (which, n, gmod, pub) == (2, N, 1, B * J) and rd * N >= B * k > (rd - 1) * N
    for q, most in ((8, 15), (4, 30)):
        for form in ("gather", "partials"):
            which, n, gmod, pub, rd, dsm = cases[f"e_cluster{q}_gather" if form == "gather"
                                                 else f"f_cluster{q}_partials"]
            assert which == 5 and gmod == q and n % q == 0 and n // q <= most
            Jc = pub // B
            assert n * Jc >= H > (n - q) * Jc
            assert rd * n >= B * k > (rd - 1) * n        # B x k / Q words from n / Q CTAs
            assert dsm == (-(-B * k // q) if form == "gather" else B * 4 * Jc)


def test_fwd_ops_count_every_product_on_ffma():
    """K3: 2 B k 4H a step, all on FFMA; K7: each site's 2 B k 4H a step on
    the TF32 tensor cores in split precision (three products for each), the
    scores and the context (2 B S H each) and the readout (2 B 2H H) a step
    on FFMA."""
    T, B, H, k = 35, 20, 650, 325
    assert sb.k3_fwd_ops(T, B, H, k) == {"tf32": 0, "f32": T * 2 * B * k * 4 * H}
    T, B, S, H = 50, 64, 50, 512
    kept = [358, 358, 358, 100]
    ops = sb.k7_fwd_ops(T, B, S, H, kept)
    assert ops["tf32"] == 3 * T * 2 * B * 4 * H * sum(kept)
    assert ops["f32"] == T * (4 * B * S * H + 4 * B * H * H)


def test_k7_floor_is_four_exchanges_a_step():
    """K7's step chains four dependent exchanges (two layers, attention,
    readout): its floor is T x 4 x the cheapest probe."""
    per_step = {"b_l2_barrier": 1.4, "f_cluster8_partials": 15.0}
    assert sb.floor_ms(per_step, 50, exchanges=4) == pytest.approx(1.4 * 50 * 4 / 1e3)
