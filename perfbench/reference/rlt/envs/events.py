"""Game event tracking: shot / goal / save / assist, batched over envs
(RocketSim GameEventTracker.{h,cpp}); bump and demo come from the arena's
per-step latches (EnvSet.cpp:31-42).
"""

from __future__ import annotations

import dataclasses

import torch

from perfbench.reference.rlt import constants as C


@dataclasses.dataclass(frozen=True)
class EventConfig:
    """GameEventTrackerConfig defaults (GameEventTracker.h:10-40)."""
    shot_min_speed: float = 1750.0
    shot_touch_min_delay: float = 0.3
    pred_score_extra_margin: float = 0.0
    shot_event_cooldown: float = 1.0
    shot_min_score_time: float = 2.0
    goal_max_touch_time: float = 4.0
    pass_max_touch_time: float = 2.0


@dataclasses.dataclass
class TrackerState:
    ball_shot: torch.Tensor        # (N,) bool
    shot_goal_team: torch.Tensor   # (N,) int32, the net being shot at
    shot_cooldown: torch.Tensor    # (N,) float32
    ball_scored_last: torch.Tensor  # (N,) bool

    @staticmethod
    def make(num_envs: int, device=None) -> "TrackerState":
        z = lambda dt: torch.zeros(num_envs, dtype=dt, device=device)  # noqa
        return TrackerState(ball_shot=z(torch.bool),
                            shot_goal_team=z(torch.int32),
                            shot_cooldown=z(torch.float32),
                            ball_scored_last=z(torch.bool))


def is_ball_probably_going_in(ball_pos, ball_vel, mut, max_time,
                              extra_margin):
    """Arena::IsBallProbablyGoingIn, soccar (Arena.cpp:827-863).
    ``ball_*``: (N, 3).  Returns (going_in (N,), goal_team (N,) int32)."""
    vy = ball_vel[:, 1]
    has_vy = torch.abs(vy) > 1e-7
    score_sign = torch.sign(vy)
    goal_y = mut.goal_base_threshold_y * score_sign
    dist = torch.abs(ball_pos[:, 1] - goal_y)
    time_to_goal = dist / torch.clamp(torch.abs(vy), min=1e-7)
    t = time_to_goal[:, None]
    gravity = torch.tensor([0.0, 0.0, mut.gravity_z], device=ball_pos.device)
    extrap = ball_pos + ball_vel * t + gravity * t ** 2 / 2
    margin = mut.ball_radius * 0.1 + extra_margin
    ok = (has_vy & (time_to_goal <= max_time)
          & (extrap[:, 2] <= C.GOAL_HEIGHT + margin)
          & (torch.abs(extrap[:, 0]) <= C.GOAL_HALF_WIDTH + margin))
    goal_team = torch.where(score_sign > 0, 1, 0).to(torch.int32)
    return ok, goal_team


def _shooter_passer(cars, teams, team, tick_count, max_shooter_ticks,
                    max_passer_ticks):
    """GetShooterPasser (GameEventTracker.cpp:5-46).  ``team``,
    ``tick_count``: (N,).  Returns (found (N,), shooter (N, P) one-hot,
    passer (N, P) one-hot)."""
    P = teams.shape[0]
    hit_tick = cars.ball_hit_tick
    valid = cars.ball_hit_valid & (teams[None, :] == team[:, None])
    recent = valid & (hit_tick + max_shooter_ticks >= tick_count[:, None])
    shooter_idx = torch.argmax(torch.where(recent, hit_tick, -1), dim=-1)
    found = recent.any(-1)
    players = torch.arange(P, device=hit_tick.device)
    shooter = (players[None, :] == shooter_idx[:, None]) & found[:, None]
    shoot_tick = torch.gather(hit_tick, 1, shooter_idx[:, None])
    passer_ok = valid & ~shooter & (hit_tick + max_passer_ticks >= shoot_tick)
    passer_idx = torch.argmax(torch.where(passer_ok, hit_tick, -1), dim=-1)
    passer = ((players[None, :] == passer_idx[:, None])
              & passer_ok.any(-1)[:, None] & found[:, None])
    return found, shooter, passer


def update_tracker(tracker: TrackerState, cars, ball, teams, tick_count,
                   goal_scored, tick_skip: int, mut,
                   cfg: EventConfig = EventConfig()):
    """One env-step update (GameEventTracker::Update, :48-158) of every
    arena.  Returns (new TrackerState, events dict name -> (N, P) bool)."""
    tickrate = 120.0
    delta_ticks = tick_skip
    delta_time = delta_ticks / tickrate
    no_event = torch.zeros_like(cars.ball_hit_valid)
    events = {k: no_event for k in
              ("goal", "assist", "shot", "shot_pass", "save")}

    scored = goal_scored
    new_goal = scored & ~tracker.ball_scored_last

    # goal / assist
    scoring_team = torch.where(ball.pos[:, 1] < 0, 1, 0).to(torch.int32)
    gfound, gshooter, gpasser = _shooter_passer(
        cars, teams, scoring_team, tick_count,
        int(cfg.goal_max_touch_time * tickrate),
        int(cfg.pass_max_touch_time * tickrate))
    fire = (new_goal & gfound)[:, None]
    events["goal"] = gshooter & fire
    events["assist"] = gpasser & fire

    # shot detection (only when not scored)
    going_in, goal_team = is_ball_probably_going_in(
        ball.pos, ball.vel, mut, cfg.shot_min_score_time,
        cfg.pred_score_extra_margin)
    speed_ok = torch.sum(ball.vel ** 2, -1) >= cfg.shot_min_speed ** 2
    cooldown = torch.clamp(tracker.shot_cooldown - delta_time, min=0.0)
    can_shoot = ~tracker.ball_shot & (tracker.shot_cooldown <= 0)

    shooter_team = (1 - goal_team).to(torch.int32)
    min_delay_ticks = int(cfg.shot_touch_min_delay * tickrate)
    sfound, sshooter, spasser = _shooter_passer(
        cars, teams, shooter_team, tick_count,
        delta_ticks + min_delay_ticks,
        int(cfg.pass_max_touch_time * tickrate))
    shooter_hit_tick = torch.sum(torch.where(sshooter, cars.ball_hit_tick, 0),
                                 -1)
    delay_ok = (tick_count - shooter_hit_tick) >= min_delay_ticks
    shot_fires = (~scored & can_shoot & speed_ok & going_in & sfound
                  & delay_ok)
    events["shot"] = sshooter & shot_fires[:, None]
    events["shot_pass"] = spasser & shot_fires[:, None]

    # save detection (the ball was shot and is no longer going in)
    save_check = ~scored & tracker.ball_shot & ~going_in
    vfound, vsaver, _ = _shooter_passer(
        cars, teams, tracker.shot_goal_team, tick_count, delta_ticks, 0)
    events["save"] = vsaver & (save_check & vfound)[:, None]

    new_ball_shot = torch.where(shot_fires, True,
                                torch.where(save_check, False,
                                            tracker.ball_shot & ~scored))
    new_cooldown = torch.where(
        shot_fires, cfg.shot_event_cooldown,
        torch.where(can_shoot, cooldown, tracker.shot_cooldown))
    new_team = torch.where(shot_fires, goal_team, tracker.shot_goal_team)
    return TrackerState(ball_shot=new_ball_shot, shot_goal_team=new_team,
                        shot_cooldown=new_cooldown,
                        ball_scored_last=scored), events
