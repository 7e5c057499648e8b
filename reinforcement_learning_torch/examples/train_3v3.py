"""Standard 3v3 on the card: the example's training program
(``train_2v2``; ExampleMain.cpp:352-584) at ``playersPerTeam = 3``, the
mode RLCS is played in.  Everything but the team size is the 2v2
program's: the 13-term reward stack (the 2v2 kickoff reward pairs each
player with its first teammate), the terminals, the 768-wide trio at
scale 1.5, the PPO and self-play settings.  Six cars an arena run the
kernel's 6-car instantiation; AdvancedObs is 9 + 8 + 34 + 29 x 6 = 225
floats; 100,000 steps an iteration are 32 env steps of 512 x 6 players,
98,304 rows, the 2v2 program's batch.

Run on the card:
    python -m reinforcement_learning_torch.examples.train_3v3 \\
        [iterations] [--render] [--scale=1.5] [--trace]
"""

from __future__ import annotations

from reinforcement_learning_torch.envs.env import RocketLeagueEnv
from reinforcement_learning_torch.examples import train_2v2

TEAM_SIZE = 3
NUM_GAMES = train_2v2.NUM_GAMES

ppo_config = train_2v2.ppo_config
selfplay_config = train_2v2.selfplay_config
step_metrics = train_2v2.step_metrics


def make_env(num_envs: int, render_mode: bool = False,
             device=None) -> RocketLeagueEnv:
    return train_2v2.make_env(num_envs, render_mode, device,
                              team_size=TEAM_SIZE)


def main(argv=None):
    train_2v2.main(argv, team_size=TEAM_SIZE)


if __name__ == "__main__":
    main()
