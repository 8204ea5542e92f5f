"""tokens_per_s: tokens the completed units consumed, over the whole
measured window.  A token is one input of one stream at one step (an
online learner's), or one prompt or generated token (a language model's)."""


def read(run):
    if run["elapsed_s"] <= 0 or not run["records"]:
        return None
    return sum(r["tokens"] for r in run["records"]) / run["elapsed_s"]
