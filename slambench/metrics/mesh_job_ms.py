"""mesh_job_ms: the periodic mesh job's wall (the span mesh_job on the
mesh worker's thread: the wait for the map's snapshot, the SDF's
queries, marching cubes, the colors, the file and the ATE), the mean
over the jobs submitted from the window's frames before the traced
stretch, in ms. Job j is the one the loop's j-th ``mesh_eval`` event
submitted (jobs run one at a time, in order), and its frame is the frame
whose wall holds that event's start. None without the span, where the
jobs and the events do not pair one to one, or without such a job."""

import bisect


def read(run):
    jobs = run.timings.get("mesh_job")
    starts = sorted(a for a, _, tag in run.events if tag == "mesh_eval")
    if not jobs or len(jobs) != len(starts):
        return None
    frames = set(run.frames())
    walls = [wall for wall, a in zip(jobs, starts)
             if bisect.bisect_right(run.walls, a) - 1 in frames]
    if not walls:
        return None
    return 1e3 * sum(walls) / len(walls)
