"""The images' share of the chip's peak: the least time of the model
FLOPs of the window's untraced images (`flops.image_least_s`: each
image's own rays, no padding; one evaluation a solver, `MODEL_ITERS`;
each block at the peak of its precision) over the seconds they took by
the host's clock, in percent. A floor: the solvers' further iterations
are work the model does that this does not count."""


def read(facts):
    if facts.get('kind') != 'render' or not facts.get('images_s'):
        return None
    return 100.0 * facts['least_s']['images'] / facts['images_s']
