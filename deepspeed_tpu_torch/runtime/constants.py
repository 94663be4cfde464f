"""Config keys and defaults: the port's own copy of
``deepspeed_tpu/runtime/constants.py`` (the reference's vocabulary, so its
JSON configs load as they are)."""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

# ZeRO offload devices
OFFLOAD_NONE = "none"
OFFLOAD_CPU = "cpu"
OFFLOAD_NVME = "nvme"

ROUTE_TRAIN = "train"
ROUTE_EVAL = "eval"
ROUTE_PREDICT = "predict"

PIPE_REPLICATED = "ds_pipe_replicated"
