"""AMP op lists (the port's copy of ``mxnet_tpu/contrib/amp/lists.py``,
itself after the reference's ``python/mxnet/contrib/amp/lists/symbol.py``).

The low-precision type is **bfloat16**: fp32's exponent range, so the
reference's fp16 overflow machinery (loss scaling) is rarely needed and is
kept for API parity.  The LP16 ops are the products an H100 runs on its
tensor cores (bf16 in, fp32 accumulation, bf16 out); the FP32 ops are the
reductions and transcendentals where precision matters; every other op
runs in the widest type of its inputs (torch's promotion).
"""

# matmul/conv-heavy -> bfloat16 on the tensor cores
TARGET_DTYPE_OPS = [
    "FullyConnected", "Convolution", "Deconvolution", "dot", "batch_dot",
    "RNN",
]

# numerically sensitive -> force float32
FP32_OPS = [
    "softmax", "log_softmax", "SoftmaxOutput", "SoftmaxActivation",
    "softmin", "Softmax",
    "exp", "log", "log2", "log10", "log1p", "expm1", "rsqrt", "erfinv",
    "norm", "L2Normalization", "LayerNorm", "InstanceNorm", "BatchNorm",
    "mean", "sum", "nansum", "prod", "nanprod",
    "linalg_gemm", "linalg_gemm2", "linalg_potrf", "linalg_trsm",
    "linalg_trmm", "linalg_sumlogdiag", "linalg_syrk",
    "smooth_l1", "CTCLoss", "ctc_loss", "make_loss", "MakeLoss",
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "SVMOutput", "Perplexity",
]

# multi-input ops whose inputs may disagree after casting: one
# amp_multicast promotes to the widest type (reference WIDEST_TYPE_CASTS)
WIDEST_TYPE_OPS = [
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "add_n", "Concat", "concat", "stack", "where",
]

# conditionally fp16-safe in the reference; here they follow their inputs
FP16_FP32_OPS = [
    "Activation", "Pooling", "Dropout", "Flatten", "Reshape", "reshape",
    "transpose", "concat", "Concat", "elemwise_add", "elemwise_mul",
    "relu", "sigmoid", "tanh",
]
