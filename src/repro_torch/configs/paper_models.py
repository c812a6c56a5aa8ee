"""The paper's configs (port of repro.configs.paper_models: the LSTM LMs of
Table 1, the Luong NMT model of Table 2 and the BiLSTM-CNN-CRF tagger of
Table 3), selectable via ``--arch``."""
from repro_torch.configs.base import ArchSpec
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.core.sdrop import DropoutSpec
from repro_torch.models import lstm_lm, seq2seq, tagger


_LM_SKIPS = {
    "prefill_32k": "word-level LSTM LM; paper shapes are (batch 20, unroll 35)",
    "decode_32k": "see prefill_32k",
    "long_500k": "see prefill_32k",
}


def _st(rate, bs=1):
    return DropoutSpec(rate=rate, block_size=bs)


def _plan(rate, bs=1, sites=("embed", "nr", "rh", "out")):
    return DropoutPlan.case("case3", rate, block_size=bs, sites=sites)


ZAREMBA_MEDIUM = ArchSpec(
    name="zaremba-medium", family="rnn", kind="lstm_lm",
    full=lambda **kw: lstm_lm.zaremba_medium(plan=_plan(0.5), **kw),
    smoke=lambda **kw: lstm_lm.zaremba_medium(
        vocab=128, embed=64, hidden=64,
        plan=DropoutPlan({"embed": _st(0.5), "nr": _st(0.5, 8),
                          "rh": _st(0.5, 8), "out": _st(0.5)}), **kw),
    skip_shapes=_LM_SKIPS)

ZAREMBA_LARGE = ArchSpec(
    name="zaremba-large", family="rnn", kind="lstm_lm",
    full=lambda **kw: lstm_lm.zaremba_large(plan=_plan(0.65), **kw),
    smoke=lambda **kw: lstm_lm.zaremba_large(
        vocab=128, embed=64, hidden=64,
        plan=DropoutPlan({"embed": _st(0.65), "nr": _st(0.65, 8),
                          "rh": _st(0.65, 8), "out": _st(0.65)}), **kw),
    skip_shapes=_LM_SKIPS)

AWD_LSTM = ArchSpec(
    name="awd-lstm", family="rnn", kind="lstm_lm",
    full=lambda **kw: lstm_lm.awd_lstm(**kw),
    smoke=lambda **kw: lstm_lm.awd_lstm(vocab=128, embed=32, hidden=48, **kw),
    skip_shapes=_LM_SKIPS)

# Luong et al. 2015 / OpenNMT: vocab 50000 each side, embed = hidden = 512,
# 2 layers; Case III p=0.3 on NR, RH and the encoder/decoder outputs.
LUONG_NMT = ArchSpec(
    name="luong-nmt", family="rnn", kind="nmt",
    full=lambda **kw: seq2seq.NMTConfig(
        plan=_plan(0.3, sites=("nr", "rh", "out")), **kw),
    smoke=lambda **kw: seq2seq.NMTConfig(
        src_vocab=96, tgt_vocab=96, embed=32, hidden=32,
        plan=_plan(0.3, 8, sites=("nr", "rh", "out")), **kw),
    skip_shapes=_LM_SKIPS)

# Ma & Hovy 2016 (the TaggerConfig defaults): word embed 100, char CNN 30
# filters of width 3 over 30-dim char embeddings, BiLSTM 2 x 200, 9 tags;
# Case III p=0.5 on the concatenated features and RH.
BILSTM_NER = ArchSpec(
    name="bilstm-ner", family="rnn", kind="tagger",
    full=lambda **kw: tagger.TaggerConfig(
        plan=_plan(0.5, sites=("inp", "rh")), **kw),
    smoke=lambda **kw: tagger.TaggerConfig(
        vocab=96, char_vocab=30, hidden=32, num_tags=9,
        word_embed=34, char_filters=30,    # 64-dim concat: 8-block divisible
        plan=_plan(0.5, 8, sites=("inp", "rh")), **kw),
    skip_shapes=_LM_SKIPS)

PAPER_SPECS = [ZAREMBA_MEDIUM, ZAREMBA_LARGE, AWD_LSTM, LUONG_NMT, BILSTM_NER]
