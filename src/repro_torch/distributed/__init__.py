from repro_torch.distributed.supervisor import StragglerWatchdog, Supervisor

__all__ = ["StragglerWatchdog", "Supervisor"]
