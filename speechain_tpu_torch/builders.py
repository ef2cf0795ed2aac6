"""Config-driven model construction: reference-style YAML ``module_conf``
blocks -> the port's model config dataclasses and nets (counterpart of
``speechain_tpu/builders.py``, :41-254). ``dtype`` is the compute dtype
and ``param_dtype`` the parameters' (float32 masters under a bf16
``dtype`` in training; left None, the parameters are stored in
``dtype``). The reference's ``bn_axis_name`` (cross-replica BatchNorm) is
not ported (ROADMAP A8): the builders take no such argument.

The reference instantiates modules by dotted-path reflection
(``import_class("speechain.module." + type)``, runner.py:683 and
module/encoder/asr.py:45-78). Here each model family has an explicit builder
that understands the same YAML surface (``frontend:``, ``normalize:``,
``specaug:``, ``enc_prenet:``, ``encoder:``, ``dec_emb:``, ``decoder:`` ...)
so reference exp_cfg files translate mechanically.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from speechain_tpu_torch.data.tokenizer import (
    CharTokenizer,
    GraphemeToPhonemeTokenizer,
    SubwordTokenizer,
    Tokenizer,
)
from speechain_tpu_torch.models.ar_asr import ARASRConfig, ARASRNet
from speechain_tpu_torch.models.ar_tts import ARTTSConfig, ARTTSNet
from speechain_tpu_torch.models.nar_tts import (FastSpeech2Config,
                                                FastSpeech2Net)
from speechain_tpu_torch.nn.lm import LanguageModelNet, LMConfig
from speechain_tpu_torch.ops.feat_norm import FeatNormConfig
from speechain_tpu_torch.ops.frontend import FrontendConfig
from speechain_tpu_torch.ops.specaug import SpecAugmentConfig

TOKENIZERS = {
    "char": CharTokenizer,
    "sentencepiece": SubwordTokenizer,
    "subword": SubwordTokenizer,
    "g2p": GraphemeToPhonemeTokenizer,
    "mfa": GraphemeToPhonemeTokenizer,
}


def build_tokenizer(token_type: str, token_path: str, **conf) -> Tokenizer:
    return TOKENIZERS[token_type](token_path=token_path, **conf)


def build_spk2idx(spk_list_path: Optional[str]) -> Optional[Dict[str, int]]:
    """Speaker list file -> {speaker: id} with 0 reserved for unknown
    (model/ar_tts.py:156-171 spk_list -> spk2idx)."""
    if not spk_list_path:
        return None
    with open(spk_list_path, "r", encoding="utf-8") as f:
        speakers = [line.strip() for line in f if line.strip()]
    return {spk: i + 1 for i, spk in enumerate(speakers)}


def _conf(block: Optional[Dict]) -> Dict[str, Any]:
    if block is None:
        return {}
    return dict(block.get("conf", block if "type" not in block else {}))


def build_frontend_config(block: Optional[Dict], **defaults) -> FrontendConfig:
    conf = _conf(block)
    known = {f for f in FrontendConfig.__dataclass_fields__}
    merged = {**defaults, **{k: v for k, v in conf.items() if k in known}}
    return FrontendConfig(**merged)


def build_specaug_config(block) -> Optional[SpecAugmentConfig]:
    if block in (None, False):
        return None
    conf = _conf(block) if isinstance(block, dict) else {}
    conf = {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in conf.items()}
    known = {f for f in SpecAugmentConfig.__dataclass_fields__}
    return SpecAugmentConfig(**{k: v for k, v in conf.items() if k in known})


def build_featnorm_config(block, feat_dim: int) -> Optional[FeatNormConfig]:
    if block in (None, False):
        return None
    conf = _conf(block) if isinstance(block, dict) else {}
    known = {f for f in FeatNormConfig.__dataclass_fields__}
    conf = {k: v for k, v in conf.items() if k in known}
    conf.setdefault("feat_dim", feat_dim)
    return FeatNormConfig(**conf)


def _encoder_type(block: Dict) -> str:
    t = block.get("type", "transformer")
    return "conformer" if "conformer" in t else "transformer"


def build_arasr(module_conf: Dict, vocab_size: int,
                customize_conf: Optional[Dict] = None,
                dtype=torch.float32,
                param_dtype: Optional[torch.dtype] = None
                ) -> Tuple[ARASRNet, ARASRConfig]:
    """ARASR from a reference-style ``module_conf`` block
    (model/ar_asr.py:37-339 surface)."""
    customize_conf = customize_conf or {}
    frontend = build_frontend_config(module_conf.get("frontend"))
    cfg = ARASRConfig(
        vocab_size=vocab_size,
        frontend=frontend,
        feat_norm=build_featnorm_config(
            module_conf.get("normalize", True), frontend.n_mels),
        specaug=build_specaug_config(module_conf.get("specaug")),
        enc_prenet=_conf(module_conf.get("enc_prenet")),
        encoder_type=_encoder_type(module_conf.get("encoder", {})),
        encoder=_conf(module_conf.get("encoder")),
        dec_emb=_conf(module_conf.get("dec_emb")),
        decoder=_conf(module_conf.get("decoder")),
        ctc_weight=float(customize_conf.get("ctc_weight", 0.0) or 0.0),
        ilm_weight=float(customize_conf.get("ilm_weight", 0.0) or 0.0),
        label_smoothing=float(customize_conf.get("label_smoothing", 0.1)),
        att_guid_sigma=float(customize_conf.get("att_guid_sigma", 0.0)),
        dtype=dtype,
        param_dtype=param_dtype,
    )
    return ARASRNet(cfg), cfg


def _spk_emb_conf(module_conf: Dict, customize_conf: Dict) -> Optional[Dict]:
    """spk_emb conf with spk_num auto-sized from customize_conf.spk_list
    (+1 for the unknown-speaker slot, model/ar_tts.py:156-171)."""
    conf = _conf(module_conf.get("spk_emb")) or None
    spk_list = (customize_conf or {}).get("spk_list")
    if spk_list:
        conf = dict(conf or {})
        spk2idx = build_spk2idx(spk_list)
        conf.setdefault("spk_num", len(spk2idx) + 1)
    return conf


def build_artts(module_conf: Dict, vocab_size: int,
                customize_conf: Optional[Dict] = None,
                dtype=torch.float32,
                param_dtype: Optional[torch.dtype] = None
                ) -> Tuple[ARTTSNet, ARTTSConfig]:
    customize_conf = customize_conf or {}
    dec_block = module_conf.get("decoder", {})
    dec_conf = _conf(dec_block) if "type" not in dec_block else \
        _conf(dec_block.get("decoder", dec_block))
    frontend = build_frontend_config(
        module_conf.get("frontend") or dec_block.get("frontend"),
        win_length=0.05, hop_length=0.0125, fmin=125.0, fmax=7600.0)
    cfg = ARTTSConfig(
        vocab_size=vocab_size,
        frontend=frontend,
        feat_norm=build_featnorm_config(
            module_conf.get("normalize",
                            dec_block.get("normalize", True)),
            frontend.n_mels),
        reduction_factor=int(
            customize_conf.get("reduction_factor",
                               dec_block.get("reduction_factor", 1))),
        enc_emb=_conf(module_conf.get("enc_emb")
                      or module_conf.get("embedding")),
        enc_prenet=_conf(module_conf.get("enc_prenet")
                         or module_conf.get("prenet")),
        encoder=_conf(module_conf.get("encoder")),
        dec_prenet=_conf(module_conf.get("dec_prenet")
                         or dec_block.get("prenet"))
        or dict(lnr_dims=[256, 256], lnr_dropout=0.5),
        decoder=dec_conf,
        postnet=_conf(module_conf.get("postnet")
                      or dec_block.get("postnet")),
        spk_emb=_spk_emb_conf(module_conf, customize_conf),
        stop_pos_weight=float(customize_conf.get("stop_pos_weight", 5.0)),
        feat_loss_type=customize_conf.get("feat_loss_type", "L2"),
        att_guid_sigma=float(customize_conf.get("att_guid_sigma", 0.0)),
        dtype=dtype,
        param_dtype=param_dtype,
    )
    return ARTTSNet(cfg), cfg


def build_fastspeech2(module_conf: Dict, vocab_size: int,
                      customize_conf: Optional[Dict] = None,
                      dtype=torch.float32,
                      param_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[FastSpeech2Net, FastSpeech2Config]:
    customize_conf = customize_conf or {}
    frontend = build_frontend_config(
        module_conf.get("frontend"), win_length=0.05, hop_length=0.0125,
        fmin=125.0, fmax=7600.0, return_energy=True)
    cfg = FastSpeech2Config(
        vocab_size=vocab_size,
        frontend=frontend,
        feat_norm=build_featnorm_config(
            module_conf.get("normalize", True), frontend.n_mels),
        pitch_norm=build_featnorm_config(
            module_conf.get("pitch_normalize", True), 1),
        energy_norm=build_featnorm_config(
            module_conf.get("energy_normalize", True), 1),
        reduction_factor=int(customize_conf.get("reduction_factor", 1)),
        enc_emb=_conf(module_conf.get("enc_emb")
                      or module_conf.get("embedding")),
        enc_prenet=_conf(module_conf.get("enc_prenet")
                         or module_conf.get("prenet")),
        encoder=_conf(module_conf.get("encoder")),
        duration_predictor=_conf(module_conf.get("duration_predictor")),
        pitch_predictor=_conf(module_conf.get("pitch_predictor")),
        energy_predictor=_conf(module_conf.get("energy_predictor")),
        decoder=_conf(module_conf.get("decoder")),
        postnet=_conf(module_conf.get("postnet")),
        spk_emb=_spk_emb_conf(module_conf, customize_conf),
        feat_loss_type=customize_conf.get("feat_loss_type", "L1"),
        dtype=dtype,
        param_dtype=param_dtype,
    )
    return FastSpeech2Net(cfg), cfg


def build_lm(module_conf: Dict, vocab_size: int,
             customize_conf: Optional[Dict] = None,
             dtype=torch.float32,
             param_dtype: Optional[torch.dtype] = None,
             ) -> Tuple[LanguageModelNet, LMConfig]:
    cfg = LMConfig(
        vocab_size=vocab_size,
        emb=_conf(module_conf.get("emb") or module_conf.get("dec_emb")),
        encoder=_conf(module_conf.get("encoder")),
        dtype=dtype,
        param_dtype=param_dtype,
    )
    return LanguageModelNet(cfg), cfg


MODEL_BUILDERS = {
    "ar_asr.ARASR": build_arasr,
    "ar_asr.MultiDataLoaderARASR": build_arasr,
    "arasr": build_arasr,
    "ar_tts.ARTTS": build_artts,
    "ar_tts.MultiDomainARTTS": build_artts,
    "artts": build_artts,
    "nar_tts.FastSpeech2": build_fastspeech2,
    "fastspeech2": build_fastspeech2,
    "lm.LM": build_lm,
    "lm": build_lm,
}


def build_model(model_cfg: Dict, vocab_size: int, dtype=torch.float32,
                param_dtype: Optional[torch.dtype] = None):
    """train_cfg.model block -> (net, cfg, builder_key)."""
    mtype = model_cfg["model_type"]
    builder = MODEL_BUILDERS[mtype]
    customize = (model_cfg.get("model_conf", {}) or {}).get(
        "customize_conf", {})
    net, cfg = builder(model_cfg.get("module_conf", {}), vocab_size,
                       customize, dtype=dtype, param_dtype=param_dtype)
    return net, cfg, mtype
