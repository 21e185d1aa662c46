from repro_torch.data.synthetic import batch_for_step, gen_tokens, optimal_loss

__all__ = ["batch_for_step", "gen_tokens", "optimal_loss"]
