"""FlatQuant run configuration (port of flatquant_tpu/quantize/spec.py).

A frozen dataclass that threads through packing and serving. Field
semantics track the reference CLI flags (flatquant/args_utils.py:28-161);
the calibration fields are carried so one config describes a run in both
packages.
"""

from __future__ import annotations

import dataclasses

from flatquant_torch.core.quant import ActQuantCfg, WeightQuantCfg


@dataclasses.dataclass(frozen=True)
class FQConfig:
    # bit widths
    w_bits: int = 4
    a_bits: int = 4
    q_bits: int = 16
    k_bits: int = 16
    v_bits: int = 16
    w_asym: bool = False
    a_asym: bool = False
    q_asym: bool = False
    k_asym: bool = False
    v_asym: bool = False
    w_groupsize: int = -1
    a_groupsize: int = -1
    q_groupsize: int = -1
    k_groupsize: int = -1
    v_groupsize: int = -1

    # learnable components
    cali_trans: bool = True
    add_diag: bool = True
    lwc: bool = True
    lac: bool = True
    direct_inv: bool = False
    separate_vtrans: bool = False

    # diag init
    diag_init: str = "sq_style"
    diag_alpha: float = 0.3

    # calibration hyperparams
    epochs: int = 15
    nsamples: int = 128
    cali_bsz: int = 4
    flat_lr: float = 5e-3
    warmup: bool = False
    deactive_amp: bool = False

    # quantizer switches
    quant_enabled: bool = True
    weight_quant_enabled: bool = True
    act_quant_enabled: bool = True

    # rn128 Kronecker split: every transform dim n splits as (n/128, 128)
    # when divisible (flatquant_tpu/core/kron.py get_decompose_dim)
    tpu_decompose: bool = False

    fp8_exact: bool = True

    # gptq
    gptq: bool = False
    gptq_percdamp: float = 0.01
    gptq_act_order: bool = False
    gptq_mse: bool = False

    @property
    def quantize(self) -> bool:
        return min(self.w_bits, self.a_bits, self.q_bits, self.k_bits,
                   self.v_bits) < 16

    def _bits(self, b: int, kind_enabled: bool = True) -> int:
        return b if (self.quant_enabled and kind_enabled) else 16

    @property
    def w_cfg(self) -> WeightQuantCfg:
        return WeightQuantCfg(
            bits=self._bits(self.w_bits, self.weight_quant_enabled),
            sym=not self.w_asym,
            perchannel=True,
            group_size=self.w_groupsize,
            mse=self.gptq_mse,
        )

    @property
    def a_cfg(self) -> ActQuantCfg:
        return ActQuantCfg(
            bits=self._bits(self.a_bits, self.act_quant_enabled),
            sym=not self.a_asym, lac=self.lac, group_size=self.a_groupsize)

    @property
    def q_cfg(self) -> ActQuantCfg:
        return ActQuantCfg(
            bits=self._bits(self.q_bits, self.act_quant_enabled),
            sym=not self.q_asym, lac=self.lac, group_size=self.q_groupsize)

    @property
    def k_cfg(self) -> ActQuantCfg:
        return ActQuantCfg(
            bits=self._bits(self.k_bits, self.act_quant_enabled),
            sym=not self.k_asym, lac=self.lac, group_size=self.k_groupsize)

    @property
    def v_cfg(self) -> ActQuantCfg:
        return ActQuantCfg(
            bits=self._bits(self.v_bits, self.act_quant_enabled),
            sym=not self.v_asym, lac=self.lac, group_size=self.v_groupsize)


# the headline W4A4KV4 recipe (scripts/llama-3/llama-3-8b/w4a4kv4.sh)
W4A4KV4 = FQConfig(
    w_bits=4,
    a_bits=4,
    k_bits=4,
    v_bits=4,
    k_asym=True,
    v_asym=True,
    k_groupsize=128,
    v_groupsize=128,
)
