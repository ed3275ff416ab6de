"""Model parallelism over ``torch.distributed`` process groups."""
