"""Watermarked images generated a second: every image of the window's
requests over the window, from the first request's start to the last
one's end (host clock). At batch 1 its inverse is the seconds a user
waits for an image."""


def read(run, name):
    return run.images / run.window_s
