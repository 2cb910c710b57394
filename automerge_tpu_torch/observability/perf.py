"""Process memory reads for the storage tier (the slice of the
reference's observability/perf.py that durability, storage and tiering
import): `rss_bytes`, `page_fault_counts`, and `register_mem_source`
re-exported from the package. The kernel cost ledger and the seam
baselines are not ported.
"""

from . import register_mem_source

__all__ = ['register_mem_source', 'rss_bytes', 'page_fault_counts']


def rss_bytes():
    """(rss, hwm) bytes of this process. Linux: VmRSS/VmHWM from
    /proc/self/status (the kernel's own high watermark); elsewhere:
    ru_maxrss doubles for both."""
    try:
        with open('/proc/self/status') as f:
            rss = hwm = 0
            for line in f:
                if line.startswith('VmRSS:'):
                    rss = int(line.split()[1]) * 1024
                elif line.startswith('VmHWM:'):
                    hwm = int(line.split()[1]) * 1024
            if rss:
                return rss, (hwm or rss)
    except OSError:
        pass
    import resource
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return peak, peak


def page_fault_counts():
    """(minor, major) page faults for this process since start. Major
    faults are the storage tier's cold-read signal: an mmap'd parked
    chunk served off the page cache costs zero; one read from disk
    costs a major fault. Linux: /proc/self/stat fields 10/12;
    elsewhere: getrusage ru_minflt/ru_majflt."""
    try:
        with open('/proc/self/stat') as f:
            # field 2 (comm) may contain spaces — split after the
            # closing paren
            rest = f.read().rsplit(')', 1)[1].split()
        # rest[0] is field 3 (state); minflt/majflt are fields 10/12
        return int(rest[7]), int(rest[9])
    except (OSError, IndexError, ValueError):
        pass
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return int(ru.ru_minflt), int(ru.ru_majflt)


