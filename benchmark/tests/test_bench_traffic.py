"""The generated traffic: the same seed gives the same frames, another seed others."""

import numpy as np

from benchmark.traffic import LaneSchedule, episode_seeds, replay_pool

MIX = {"episodes": 2, "steps": 5, "spin": 2, "plans": ["two_room_plan", "open_room_plan"],
       "env": {"width": 32, "height": 24}}


def test_same_seed_same_pool():
    a, b = replay_pool(MIX, 2**31 + 11), replay_pool(MIX, 2**31 + 11)
    for x, y in zip(a, b):
        assert x["seed"] == y["seed"]
        for k in ("depth", "rgb", "heading", "xy"):
            np.testing.assert_array_equal(x[k], y[k])


def test_other_seed_other_pool():
    a, b = replay_pool(MIX, 1), replay_pool(MIX, 2)
    assert any(not np.array_equal(x["rgb"], y["rgb"]) for x, y in zip(a, b))


def test_every_episode_has_its_steps():
    pool = replay_pool(MIX, 5)
    assert [p["depth"].shape for p in pool] == [(5, 24, 32)] * 2
    assert all(p["rgb"].dtype == np.uint8 and p["rgb"].shape == (5, 24, 32, 3) for p in pool)


def test_seeds_take_any_whole_number():
    assert episode_seeds(2**40 + 3, 4) == episode_seeds(2**40 + 3, 4)
    assert episode_seeds(2**40 + 3, 4) != episode_seeds(2**40 + 4, 4)


def test_lane_schedule_staggers_and_resets():
    s = LaneSchedule(lanes=2, episodes=3, steps=4, stagger=2)
    seen = []
    for _ in range(6):
        seen.append(s.current())
        s.advance()
    assert seen[0] == [(0, 0, True), (1, 2, True)]
    assert seen[1] == [(0, 1, False), (1, 3, False)]
    assert seen[2] == [(0, 2, False), (2, 0, True)]  # lane 1 ended and took episode 2
    assert seen[4] == [(0, 0, True), (2, 2, False)]  # lane 0 took episode 3, round the pool of 3
