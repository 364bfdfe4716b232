from repro_torch.kernels.event_loop.ops import event_loop

__all__ = ["event_loop"]
