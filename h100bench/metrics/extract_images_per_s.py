"""Images through extraction a second: every image of the window's requests
over the window, from the first request's start to the last one's end
(host clock)."""


def read(run, name):
    return run.images / run.window_s
