"""The closed loop: one analyst asks the mix's questions in order, each
when the previous answer is back, round after round, until the window's
deadline; a round the deadline falls in ends there.  The first round that
starts at or after the window's check time runs whole and is kept for the
check; when none has by the deadline, one more round does."""


def run(window):
    clients = int(window.mix["clients"])
    if clients != 1:
        raise ValueError(f"the closed loop runs one client, not {clients}")
    while not (window.over() and window.kept):
        keep = not window.kept and (window.over() or window.now() >= window.check_time)
        for i in range(len(window.questions)):
            if i and not keep and window.over():
                break
            window.ask(i, keep)
        window.kept = window.kept or keep
        window.rounds += 1
