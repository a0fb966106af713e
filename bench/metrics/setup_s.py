"""Set-up seconds: from the harness's start to the window's opening —
imports, weights, building the program, the kernel build where one is
due, and the warm-up (host clock)."""


def read(run):
    return run["record"]["setup_s"]
