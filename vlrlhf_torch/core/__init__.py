"""The distribution runtime under the trainers (counterpart of
vlrlhf_tpu/core): the (data, fsdp, model) device mesh, the process group
and its host collectives, and the plan that places every parameter."""
