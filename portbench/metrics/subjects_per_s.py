"""Subjects of every iteration completed in the window, over all
processes (a padded or short last minibatch counts its real subjects), per
second of the window."""


def read(run):
    return run.subjects / run.window_s
