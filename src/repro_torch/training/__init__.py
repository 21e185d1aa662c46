from repro_torch.training.trainer import (init_train_state, make_eval_step,
                                         make_train_step, to_device,
                                         value_and_grad)

__all__ = ["make_train_step", "make_eval_step", "init_train_state",
           "to_device", "value_and_grad"]
