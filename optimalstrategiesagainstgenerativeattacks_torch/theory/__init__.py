from optimalstrategiesagainstgenerativeattacks_torch.theory.game_value import (
    game_value_mnk,
    game_value_as_func_of_n,
    game_value_rho_delta,
    ml_attacker_game_value_rho_delta,
    game_value_diff_ml_vs_opt_rho_delta,
)

__all__ = [
    "game_value_mnk",
    "game_value_as_func_of_n",
    "game_value_rho_delta",
    "ml_attacker_game_value_rho_delta",
    "game_value_diff_ml_vs_opt_rho_delta",
]
