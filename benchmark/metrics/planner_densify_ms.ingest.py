"""The host planner's densify phase a unit, in ms summed over its threads
(``native.plan_prof``, read over the window)."""


def read(readings):
    r = readings[0] if readings else None
    if not r or not r["all_steps"] or "densify_ms" not in r["extra"]:
        return None
    return r["extra"]["densify_ms"] / r["all_steps"]
