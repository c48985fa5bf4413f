"""Quantization (counterpart of ``paddle_tpu/quant``): weight-only int8 /
int4 quantization with its fused dequant-matmul kernel, QAT
(``fake_quant``, ``FakeQuantLinear``), PTQ with activation observers into
``W8A8Linear``, and the GPTQ and AWQ passes that choose the codes."""
from .gptq_awq import (AWQLinear, awq_quantize_model, awq_search_scale,
                       capture_linear_inputs, gptq_quantize_model,
                       gptq_quantize_weight)
from .weight_only import (QuantizedLinear, dequantize_weight,
                          linear_quant_meta, pack_int4, quantize_blockwise,
                          quantize_model, weight_only_linear)
from .qat import FakeQuantLinear, fake_quant
from .ptq import PTQ, AbsMaxObserver, W8A8Linear

__all__ = ["AWQLinear", "awq_quantize_model", "awq_search_scale",
           "capture_linear_inputs", "gptq_quantize_model",
           "gptq_quantize_weight", "QuantizedLinear", "dequantize_weight",
           "linear_quant_meta",
           "pack_int4", "quantize_blockwise", "quantize_model",
           "weight_only_linear", "FakeQuantLinear", "fake_quant", "PTQ",
           "AbsMaxObserver", "W8A8Linear"]
