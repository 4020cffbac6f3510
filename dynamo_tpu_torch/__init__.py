"""PyTorch/CUDA port of the dynamo_tpu serving engine for NVIDIA Hopper."""
