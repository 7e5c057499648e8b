"""2v2 kickoff shaping reward with goer/cheater role assignment
(Rewards/KickoffProximityReward2v2Enhanced.h:1-368), batched over envs.

During an active kickoff each player is scored as GOER (races the ball) or
CHEATER (the strategic second man), with dynamic positioning, boost
management, rotation preparation, opponent awareness and anti-camping
terms.  As in the JAX package, a player without a teammate takes player
0's fields as its mate's (the argmax of an all-False row) and gets 0, and
a player without an opponent sees an infinitely far closest opponent.
"""

from __future__ import annotations

import torch

from perfbench.reference.rlt import constants as C
from perfbench.reference.rlt import maths as m
from perfbench.reference.rlt.envs.rewards import RewardCtx, goal_back


def kickoff_proximity_reward_2v2(goer_reward: float = 1.2,
                                 cheater_reward: float = 0.6,
                                 rotation_prep_weight: float = 0.2):
    """The reference class's tunables (:9-12); ``cheater_reward`` is
    accepted and unused, as there."""
    tables = {}   # device -> (big-pad locations (6, 3), field centre)

    def fn(ctx: RewardCtx) -> torch.Tensor:
        cars, ball, teams = ctx.cars, ctx.ball, ctx.teams
        P = teams.shape[0]
        dev = teams.device
        if dev not in tables:
            tables[dev] = (
                torch.as_tensor(C.BOOST_PAD_LOCS_SOCCAR[C.BOOST_PAD_IS_BIG],
                                dtype=torch.float32, device=dev),
                torch.tensor([0.0, 0.0, 100.0], device=dev))
        pads, field_center = tables[dev]
        pos, vel = cars.pos, cars.vel                       # (N, P, 3)
        bpos = ball.pos[:, None, :]                         # (N, 1, 3)

        # --- kickoff detection (:48-57)
        active = ((m.norm(ball.vel) < 2.0) & (ball.pos[:, 2] < 150.0)
                  & (m.norm(ball.pos[:, :2]) < 50.0))       # (N,)
        dist_ball = m.norm(pos - bpos)                      # (N, P)

        # --- team analysis (:59-94): teammate = other same-team player
        same = ((teams[:, None] == teams[None, :])
                & ~torch.eye(P, dtype=torch.bool, device=dev))
        has_teammate = same.any(1)
        mate_idx = torch.argmax(same.to(torch.int32), dim=1)
        mate_pos = pos[:, mate_idx]
        mate_vel = vel[:, mate_idx]
        mate_boost = cars.boost[:, mate_idx]
        mate_dist_ball = dist_ball[:, mate_idx]

        opp = teams[:, None] != teams[None, :]
        opp_dists = torch.where(opp[None], dist_ball[:, None, :],
                                torch.inf)
        closest_opp_dist = opp_dists.amin(-1)
        n_opp = torch.clamp(opp.sum(1), min=1)
        opp_com = torch.einsum("pq,nqi->npi", opp.to(torch.float32),
                               pos) / n_opp[None, :, None]

        # --- role assignment (:96-118)
        to_ball = m.normalize(bpos - pos)
        mate_to_ball = m.normalize(bpos - mate_pos)
        vel_to_ball = m.dot(vel, to_ball)
        mate_vel_to_ball = m.dot(mate_vel, mate_to_ball)
        dist_score = torch.where(dist_ball < mate_dist_ball, 0.4, 0.0)
        speed_score = torch.where(vel_to_ball > mate_vel_to_ball, 0.3, 0.0)
        boost_score = torch.where(cars.boost > mate_boost + 10.0, 0.2, 0.0)
        ang_p = torch.atan2(pos[..., 1] - bpos[..., 1],
                            pos[..., 0] - bpos[..., 0])
        ang_m = torch.atan2(mate_pos[..., 1] - bpos[..., 1],
                            mate_pos[..., 0] - bpos[..., 0])
        spawn_score = torch.where(torch.abs(ang_p - ang_m) > torch.pi / 3,
                                  1.0, 0.0) * 0.1
        is_goer = (dist_score + speed_score + boost_score
                   + spawn_score) >= 0.5

        # --- goer reward (:131-157)
        base = torch.where(dist_ball < closest_opp_dist, goer_reward,
                           -goer_reward * 0.5)
        speed_bonus = torch.clamp(vel_to_ball / 2300.0, -0.3, 0.3)
        boost_eff = torch.where(
            (cars.boost > 50.0) & (dist_ball > 1000.0), 0.1,
            torch.where((cars.boost < 20.0) & (dist_ball > 800.0), -0.15,
                        0.0))
        approach = m.dot(to_ball, m.normalize(vel))
        angle_bonus = torch.clamp(approach, min=0.0) * 0.2
        goer_r = torch.clamp(base + speed_bonus + boost_eff + angle_bonus,
                             -1.5, 1.5)

        # --- cheater reward (:160-186)
        own_goal = goal_back(teams != 0)                    # (P, 3)
        # dynamic ideal position (:188-224)
        base_ideal = (own_goal + field_center * 1.3) * 0.5
        threat_vec = m.normalize(opp_com - own_goal) * 200.0
        mate_far = m.norm(mate_pos - field_center) > 1500.0
        mate_off = torch.where(
            mate_far[..., None],
            m.normalize(mate_pos - base_ideal) * 300.0, 0.0)
        ideal = base_ideal + threat_vec * 0.3 + mate_off * 0.2
        ideal = torch.stack([
            torch.clamp(ideal[..., 0], -3000.0, 3000.0),
            torch.clamp(ideal[..., 1], -4000.0, 4000.0),
            torch.clamp(ideal[..., 2], min=17.0)], dim=-1)
        d_ideal = m.norm(pos - ideal)

        # positioning (:226-249)
        pos_r = torch.where(
            d_ideal <= 600.0, 0.5 * (1.0 - d_ideal / 600.0),
            torch.where(
                d_ideal <= 1200.0,
                0.5 * (1.0 - (d_ideal - 600.0) / 600.0) * 0.7,
                torch.where(d_ideal <= 2000.0,
                            -0.1 * (d_ideal - 1200.0) / 800.0, -0.3)))

        # strategic boost (:251-301), big pads only
        d_pads = m.norm(pos[..., None, :] - pads)           # (N, P, 6)
        accessibility = 1.0 - torch.clamp(d_pads / 1500.0, 0.0, 1.0)
        is_corner = ((torch.abs(pads[:, 0]) > 2500.0)
                     & (torch.abs(pads[:, 1]) > 3500.0))
        base_val = torch.where(is_corner, 0.8, 0.6)
        d_ball_pad = m.norm(pads - ball.pos[:, None, :])    # (N, 6)
        proximity = 1.0 - torch.clamp(d_ball_pad / 3000.0, 0.0, 1.0)
        strategic = (base_val * (0.3 + proximity * 0.7))[:, None, :]
        d_opp_pad = m.norm(opp_com[..., None, :] - pads)
        deny = torch.clamp(1.0 - d_opp_pad / 2000.0, 0.0, 0.3)
        best_boost = (accessibility * (strategic + deny)).amax(-1)
        boost_factor = torch.where(
            cars.boost < 30.0, 1.5, torch.where(cars.boost > 80.0, 0.5, 1.0))
        boost_r = best_boost * boost_factor * 0.25

        # rotation preparation (:304-335)
        mate_to_goal = m.normalize(own_goal - mate_pos)
        perp = m.normalize(torch.stack(
            [-mate_to_goal[..., 1], mate_to_goal[..., 0],
             torch.zeros_like(mate_to_goal[..., 0])], dim=-1))
        support = mate_pos + mate_to_goal * 800.0 + perp * 600.0
        d_support = m.norm(pos - support)
        readiness = 1.0 - torch.clamp(d_support / 1000.0, 0.0, 1.0)
        v_align = torch.clamp(
            m.dot(m.normalize(vel), m.normalize(support - pos)), min=0.0)
        rot_r = (readiness * 0.7 + v_align * 0.3) * rotation_prep_weight

        # opponent awareness (:337-346)
        aware = m.dot(m.normalize(opp_com - pos), to_ball)
        aware_r = torch.clamp(aware * 0.5 + 0.5, 0.0, 1.0) * 0.1

        # anti-camping (:348-366)
        d_goal = m.norm(pos - own_goal)
        ball_d_goal = m.norm(bpos - own_goal)
        min_dist = torch.where(ball_d_goal < 2000.0, 800.0 * 0.7, 800.0)
        camp_r = torch.where(d_goal < min_dist,
                             -0.4 * (1.0 - d_goal / min_dist), 0.0) * 0.05

        cheater_r = torch.clamp(pos_r + boost_r + rot_r + aware_r + camp_r,
                                -0.8, 0.8)

        out = torch.where(is_goer, goer_r, cheater_r)
        return torch.where(active[:, None] & has_teammate[None, :], out, 0.0)

    fn.__name__ = "KickoffProximityReward2v2Enhanced"
    return fn
