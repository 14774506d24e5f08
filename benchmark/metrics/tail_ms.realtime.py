"""Milliseconds a frame that the viewer waits after its render, on the
device's clock: from the frame's last beam-kernel end to the end of the
display's copy to the host (the blend, the tone map, the copy and the
launch gaps between them), the mean over the window's frames.  A frame is
the span from one device-to-host copy to the next; the host's spans are
not used for the time, since the trace's host and device clocks can sit
a millisecond apart.  None where the window holds no
``pt.realtime.step`` span (a program without spans)."""

KERNEL, COPY, STEP = "beam_kernel", "Memcpy DtoH", "pt.realtime.step"


def read(trace):
    tails = []
    for r in trace.ranks:
        if not any(s[0] == STEP for s in r.in_window(r.spans)):
            return None
        kernels = sorted(r.in_window(r.named(KERNEL)), key=lambda k: k[2])
        copies = sorted((c for c in r.in_window(r.device)
                         if c[0].startswith(COPY)), key=lambda c: c[1])
        i, last, after = 0, None, float("-inf")
        for _, start, end in copies:
            while i < len(kernels) and kernels[i][2] <= start:
                if kernels[i][2] > after:
                    last = kernels[i]
                i += 1
            if last is not None:
                tails.append((end - last[2]) / 1e3)
            last, after = None, end
    return sum(tails) / len(tails) if tails else None
