"""Personalized recommendation (counterpart of
``paddle_tpu.models.recommender``): the book ``recommender_system`` config.
A user tower (id, gender, age and job embeddings → fc) and a movie tower
(id embedding, mean-pooled category and title embeddings → fc), their
cosine similarity scaled to the rating range, and ``square_error_cost``.
``build(make_model(...))`` has the JAX program's parameter names
(``usr_emb/w`` ... ``mov_fc/b``)."""

from __future__ import annotations

import torch

from .. import layers as L


def make_model(num_users=944, num_movies=1683, num_genders=2, num_ages=7,
               num_jobs=21, num_categories=18, title_vocab=1000,
               emb_dim=32, fc_dim=200):
    """Inputs: user_id/gender_id/age_id/job_id [b, 1] int, movie_id [b, 1],
    category_ids [b, n_cat] (0-padded), title_ids [b, n_title] (0-padded),
    score [b, 1] float rating."""

    def usr_mov_net(user_id, gender_id, age_id, job_id, movie_id,
                    category_ids, title_ids, score):
        # the user tower
        feats = [
            L.embedding(user_id, size=[num_users, emb_dim], name="usr_emb"),
            L.embedding(gender_id, size=[num_genders, emb_dim // 2], name="gender_emb"),
            L.embedding(age_id, size=[num_ages, emb_dim // 2], name="age_emb"),
            L.embedding(job_id, size=[num_jobs, emb_dim // 2], name="job_emb"),
        ]
        usr = torch.cat([f.reshape(f.shape[0], -1) for f in feats], dim=-1)
        usr = L.fc(usr, fc_dim, act="tanh", name="usr_fc")

        # the movie tower: category and title id lists (0 = padding) are
        # mean-pooled, the reference's sequence_pool('average')
        mov_id = L.embedding(movie_id, size=[num_movies, emb_dim], name="mov_emb")
        mov_id = mov_id.reshape(mov_id.shape[0], -1)

        def pooled(ids, vocab, name):
            e = L.embedding(ids, size=[vocab, emb_dim // 2], name=name)
            m = (ids != 0).to(e.dtype)[..., None]
            return (e * m).sum(1) / torch.clamp_min(m.sum(1), 1.0)

        cat = pooled(category_ids, num_categories, "cat_emb")
        title = pooled(title_ids, title_vocab, "title_emb")
        mov = torch.cat([mov_id, cat, title], dim=-1)
        mov = L.fc(mov, fc_dim, act="tanh", name="mov_fc")

        # cosine similarity scaled to [0, 5]
        pred = 5.0 * L.cos_sim(usr, mov)
        loss = L.mean(L.square_error_cost(pred, score))
        return {"loss": loss, "pred": pred}

    return usr_mov_net


__all__ = ["make_model"]
