"""Progressive accumulation on a fixed camera, as Lupin's headless loop
runs it (example1.rs:39-53; the port's `render_progressive`): one
`render/renderer.py::pathtrace_scene` call per accumulation, the counter
advancing from 0, `stats["rays"]` read from every dispatch. After
`accumulations` accumulations the image is done and the next one starts at
counter 0 (a new image of the same view), back to back.
"""

from __future__ import annotations

from lupin_bench import port
from lupinpathtracer_tpu_torch.render import renderer


class Loop(port.Loop):
    unit = "accumulation"

    def __init__(self, *a):
        super().__init__(*a)
        self.desc = port.path_desc(self.cam, self.render, self.seed32)
        self.per_image = int(self.traffic["accumulations"])

    def warmup(self):
        self.begin()
        self.step(0)
        port.sync(self.device)

    def begin(self):
        self.img = self.image()
        self.done = None
        self.unit_rays = []

    def step(self, i):
        counter = i % self.per_image
        self.desc.accum_params.accumulate = True
        self.desc.accum_params.counter = counter
        stats = {}
        with self.spans("pathtrace_scene"):
            self.img = renderer.pathtrace_scene(self.ts, self.img, self.desc,
                                                self.baked, stats)
        self.unit_rays.append(stats["rays"])
        if counter == self.per_image - 1:
            self.done = self.img

    def end(self):
        return dict(rays=sum(self.unit_rays), unit_rays=self.unit_rays)

    def checked(self, units: int):
        """(the image the check compares, its accumulations): the last
        image done in the window, or the one in progress where none was."""

        if self.done is not None:
            return self.done, self.per_image
        return self.img, units

    def free(self):
        self.ts = self.img = self.done = None
