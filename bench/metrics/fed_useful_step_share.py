"""Real client-steps over the batched steps times the participants, over the
window's rounds: ``RoundRecord.local_steps`` against the cohort engine's
``last_round_stats["cohort_steps"]``."""


def read(ctx):
    return ctx.get("useful_step_share")
